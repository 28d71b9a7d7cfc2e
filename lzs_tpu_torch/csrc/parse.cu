// Lane-parallel token parse of container blocks: sync records -> packed
// token records, in one of two layouts (one kernel template, two store
// policies):
//
//   recs[b, 4*s + k, l]  (StepMajor, JAX's layout, decode2._parse_full)
//                        record of substep k of word step s of lane l
//                        (opos << 13 | is_copy << 11 | payload, or -1)
//   flat[b, l*S + 4*s + k]  (LaneMajor, decode2._parse_flat; S = 4 *
//                        (span/32 + 2)) the same records lane-major, each
//                        one below 0 stored as -1, the row padded with -1
//                        to its width: the record fill's input, which K8
//                        (cummax_rows) fills as it is
//   out_final[b, l]      the lane's output position after its last step
//
// Replaces: lzs_tpu/ops/decode2.py _parse_full, a lax.scan over
// span/32 + 2 word steps of 4 parse substeps each (no Pallas kernel: XLA
// runs the scan on the TPU as one loop). Lane l of block b starts at its
// sync record (bit offset sync_bit[b, l]; output offset, mode and current
// match offset packed in sync_out[b, l]) and parses while its bit position
// lies before the next lane's record (the last lane stops at its own, so
// it parses nothing), on the bits fed so far. Step s feeds the lane's word
// l*wpl - 1 + s, the big-endian bytes 4i..4i+3 of the block's row, zero
// for a word before the row, at or past L*wpl words (the TPU form cuts the
// stream there) and for bytes past C; the lane keeps the last two words as
// a 64-bit register and decodes a token at the top 24 bits of its current
// bit position (substep as decode2._parse_substep, lzs-decompression.c
// 214-343 and 713-730). Arithmetic is that of the TPU form: int32 that
// wraps, uint32 words, an arithmetic shift for sync_out >> 18 (a record
// with bit 31 set gives a negative payload, which the OR spreads over the
// high bits, as in JAX).
//
// Bound: operations and latency. Each lane runs 4 * (span/32 + 2)
// dependent substeps of ~50-80 integer operations; the bytes are few (the
// row read once, 4 bytes of records written per lane-substep: 49 MB at
// 256 blocks of 32768 bytes, 0.015 ms at 3.35 TB/s). At the main path's
// 256 blocks x 146 lanes there are 37,376 lanes, about 2.2 warps per
// warp scheduler of the card: few warps to hide a serial chain, so what
// counts is the instructions per substep and the chain's length.
//
// Design: one thread per (block, lane), lanes fastest, the state (two
// words, bit and output positions, mode, match offset) in registers for
// the whole walk.
//   * A CTA is one warp, so the 1,168 warps of the main path spread 8 or
//     9 to an SM (CTAs of 64 threads put 8 or 10 there).
//   * Each lane reads its own 4*wpl + 8 contiguous bytes, one word per
//     step, through the read-only path, two steps ahead of its parse: L1
//     keeps the 32-byte sector between the 8 steps that read it. Every
//     load address depends on (b, l, s) alone, never on the records, so
//     corrupt records read nothing out of bounds. Where every row starts
//     4-byte aligned (C % 4 == 0 and an aligned base), a word is one
//     predicated load and a byte swap; else four bytes.
//   * The substep's window is one 64-bit funnel shift of the two-word
//     register (the bit offset clamped to 0..63 as in JAX); a short-offset
//     head is moved 4 bits down to the long-offset layout so that both
//     read their fields at the same places; the extension nibbles' count
//     and its consume come from one count of leading ones.
//   * The lane-major store keeps a step's 4 records in registers, clamped,
//     and writes two steps at once, 32 bytes, a whole sector (a lane's
//     records are 16 * (span/32 + 2) bytes apart from the next lane's);
//     the lanes of a row write its pad columns after their walk. The
//     step-major store writes one record per substep, the lanes of a row
//     side by side.
#include "scan.cuh"

namespace {

constexpr int kParseThreads = 32;
constexpr int kSubsteps = 4;   // tokens parseable per fed 32-bit word
constexpr int kMaxStepBits = 24;
constexpr int kExt = 15;       // MAX_EXTENDED_LENGTH

// int32 addition that wraps, as int32 does in JAX and in torch.
__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

// Word i of a row of c bytes that holds nwords words (see above). An
// aligned row (c % 4 == 0) holds a word whole or not at all: its words
// are 0 <= i < wlim = min(nwords, c / 4), one predicated load and no
// branch (a branch here slowed the parse, PERF.md); else the word's
// bytes one at a time.
template <bool kAligned>
__device__ __forceinline__ uint32_t load_word(const uint8_t* row, int64_t c,
                                              int i, unsigned wlim,
                                              int64_t nwords) {
  if (kAligned) {
    unsigned raw = 0;
    if (static_cast<unsigned>(i) < wlim)
      raw = __ldg(reinterpret_cast<const unsigned*>(row) + i);
    return __byte_perm(raw, 0, 0x0123);
  }
  if (i < 0 || i >= nwords) return 0u;
  const int64_t p = 4 * static_cast<int64_t>(i);
  uint32_t w = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    w = (w << 8) | (p + k < c ? static_cast<uint32_t>(__ldg(row + p + k)) : 0u);
  }
  return w;
}

// One substep: decode a token at bit position `bitpos` of the window
// `pair` (the last two fed words, `base` the bit position of its top
// bit), if the lane can (before its end, and the token's 24 bits fed:
// `ebits`). Returns the record (-1 where nothing was parsed or the token
// has no output) and moves the state on.
__device__ __forceinline__ int substep(uint64_t pair, int base, int ebits,
                                      int end_bit, int& bitpos, int& outpos,
                                      int& mode, int& cur_off) {
  const int sh = min(max(wrap_add(bitpos, -base), 0), 63);
  const uint32_t w = static_cast<uint32_t>((pair << sh) >> 32);
  const bool can =
      bitpos < end_bit && wrap_add(bitpos, kMaxStepBits) <= ebits;

  // NORMAL: one token head; a short offset (bit 30) moved to the long
  // one's layout: offset from bit 19, length code at bits 18-15
  const bool is_lit = static_cast<int>(w) >= 0;
  const bool short_off = ((w >> 30) & 1) != 0;
  const uint32_t v = short_off ? w >> 4 : w;
  const int n_off = static_cast<int>((v >> 19) & (short_off ? 0x7Fu : 0x7FFu));
  const int l4 = static_cast<int>((v >> 15) & 0xF);
  const bool long_len = l4 >= 12;
  const int n_len = is_lit ? 1 : long_len ? (l4 & 3) + 5 : (l4 >> 2) + 2;
  const int n_consume =
      is_lit ? 9 : (short_off ? 11 : 15) + (long_len ? 2 : 0);
  const int n_mode = !is_lit && l4 == 15;
  const int lit = static_cast<int>((w >> 23) & 0xFF);

  // EXTENDED: up to 6 nibbles (24 valid bits); z = 4 * nf + 0..3 leading
  // ones, at most 24 (the low byte is set)
  const int z = __clz(static_cast<int>(~w | 0xFFu));
  const int nf4 = z & ~3;
  const bool whole = z >= 24;
  const int term = static_cast<int>((w << nf4) >> 28);
  const int e_len = whole ? 6 * kExt : kExt * (nf4 >> 2) + term;
  const int e_consume = whole ? 24 : nf4 + 4;

  const bool is_ext = mode == 1;
  const bool is_copy = is_ext || !is_lit;
  const int payload = is_ext ? cur_off : (is_lit ? lit : n_off);
  const int length = is_ext ? e_len : n_len;
  const int consume = is_ext ? e_consume : n_consume;
  const uint32_t packed = (static_cast<uint32_t>(outpos) << 13) |
                          (is_copy ? 1u << 11 : 0u) |
                          static_cast<uint32_t>(payload);
  const int rec = can && length > 0 ? static_cast<int>(packed) : -1;
  if (can) {
    bitpos = wrap_add(bitpos, consume);
    outpos = wrap_add(outpos, length);
    if (!is_ext && !is_lit) cur_off = n_off;
    mode = is_ext ? whole : n_mode;
  }
  return rec;
}

// JAX's layout: recs[b, 4*s + k, l], as parsed.
struct StepMajor {
  int* recs;
  int* lane = nullptr;
  int stride = 0;

  __device__ __forceinline__ void place(int64_t b, int l, int nslots,
                                        int nsteps) {
    stride = nslots;
    lane = recs + b * (static_cast<int64_t>(nsteps) * kSubsteps * nslots) + l;
  }
  __device__ __forceinline__ void step(int s, const int* r) {
#pragma unroll
    for (int k = 0; k < kSubsteps; ++k)
      lane[static_cast<int64_t>(s * kSubsteps + k) * stride] = r[k];
  }
  __device__ __forceinline__ void finish(int, int, int) {}
};

// The fill's layout: flat[b, l*S + 4*s + k], below 0 as -1, rows of
// `width` (a multiple of 4) padded with -1. A step's records are one
// int4; an even step is held until the odd one after it, and the two go
// out as one 32-byte sector (aligned where span/32 is even): sectors
// written half at a time, at a 16 * (span/32 + 2)-byte stride between
// lanes, made the kernel slower than the step-major form (PERF.md).
struct LaneMajor {
  int* flat;
  int width;
  int* row = nullptr;
  int4* lane = nullptr;
  int4 held = {};

  __device__ __forceinline__ void place(int64_t b, int l, int, int nsteps) {
    row = flat + b * width;
    lane = reinterpret_cast<int4*>(row) + static_cast<int64_t>(l) * nsteps;
  }
  __device__ __forceinline__ void step(int s, const int* r) {
    const int4 q = make_int4(max(r[0], -1), max(r[1], -1), max(r[2], -1),
                             max(r[3], -1));
    if (s & 1) {
      lane[s - 1] = held;
      lane[s] = q;
    } else {
      held = q;
    }
  }
  __device__ __forceinline__ void finish(int l, int nslots, int nsteps) {
    if (nsteps & 1) lane[nsteps - 1] = held;
    for (int p = nslots * nsteps * kSubsteps + l; p < width; p += nslots)
      row[p] = -1;
  }
};

template <bool kAligned, class Store>
__global__ void __launch_bounds__(kParseThreads)
parse_lanes_kernel(const uint8_t* __restrict__ comp, int64_t c,
                   const int* __restrict__ sync_bit,
                   const int* __restrict__ sync_out, int rows, int nslots,
                   int wpl, Store store, int* __restrict__ out_final) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<int64_t>(rows) * nslots) return;
  const int64_t b = t / nslots;
  const int l = static_cast<int>(t - b * nslots);
  const uint8_t* row = comp + b * c;
  const int* sb = sync_bit + b * nslots;
  const int nsteps = wpl + 2;
  const int64_t nwords = static_cast<int64_t>(nslots) * wpl;
  const unsigned wlim = static_cast<unsigned>(min(nwords, c / 4));
  const int word0 = l * wpl - 1;
  store.place(b, l, nslots, nsteps);

  const int so = sync_out[t];
  const int end_bit = sb[l + 1 < nslots ? l + 1 : l];
  int bitpos = sb[l];
  int outpos = so & 0x1FFFF;
  int mode = (so >> 17) & 1;
  int cur_off = so >> 18;            // arithmetic: JAX's int32 >>
  uint32_t lo = 0;
  uint32_t next = load_word<kAligned>(row, c, word0, wlim, nwords);
  uint32_t after = load_word<kAligned>(row, c, word0 + 1, wlim, nwords);
  // bits fed so far (exclusive) at step s: (l*wpl - 1 + s + 1) * 32, int32
  int ebits = static_cast<int>(static_cast<unsigned>(l) *
                               static_cast<unsigned>(wpl) * 32u);

  for (int s = 0; s < nsteps; ++s) {
    const uint64_t pair = static_cast<uint64_t>(lo) << 32 | next;
    lo = next;
    next = after;
    after = load_word<kAligned>(row, c, word0 + s + 2, wlim, nwords);
    const int base = wrap_add(ebits, -64);
    int r[kSubsteps];
#pragma unroll
    for (int k = 0; k < kSubsteps; ++k)
      r[k] = substep(pair, base, ebits, end_bit, bitpos, outpos, mode,
                     cur_off);
    store.step(s, r);
    ebits = wrap_add(ebits, 32);
  }
  store.finish(l, nslots, nsteps);
  out_final[t] = outpos;
}

template <class Store>
void launch_parse(bool aligned, int blocks, cudaStream_t s,
                  const uint8_t* comp, int c, const int* sync_bit,
                  const int* sync_out, int rows, int nslots, int wpl,
                  const Store& store, int* out_final) {
  if (aligned) {
    parse_lanes_kernel<true, Store><<<blocks, kParseThreads, 0, s>>>(
        comp, c, sync_bit, sync_out, rows, nslots, wpl, store, out_final);
  } else {
    parse_lanes_kernel<false, Store><<<blocks, kParseThreads, 0, s>>>(
        comp, c, sync_bit, sync_out, rows, nslots, wpl, store, out_final);
  }
}

}  // namespace

// width 0: JAX's step-major records into `recs`; else the lane-major,
// clamped rows of `width` int32 (a multiple of 4, at least
// nslots * 4 * (wpl + 2), 16-byte aligned) into `recs`.
LZS_API int lzs_parse_lanes(const uint8_t* comp, const int* sync_bit,
                            const int* sync_out, int rows, int c, int nslots,
                            int wpl, int* recs, int width, int* out_final,
                            int device, void* stream) {
  const lzs::DeviceGuard guard(device);
  const int64_t lanes = static_cast<int64_t>(rows) * nslots;
  const int blocks =
      static_cast<int>((lanes + kParseThreads - 1) / kParseThreads);
  const bool aligned =
      c % 4 == 0 && reinterpret_cast<uintptr_t>(comp) % 4 == 0;
  const auto s = static_cast<cudaStream_t>(stream);
  if (width == 0) {
    launch_parse(aligned, blocks, s, comp, c, sync_bit, sync_out, rows,
                 nslots, wpl, StepMajor{recs}, out_final);
  } else {
    if (width % 4 != 0 ||
        width < static_cast<int64_t>(nslots) * kSubsteps * (wpl + 2) ||
        reinterpret_cast<uintptr_t>(recs) % 16 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    launch_parse(aligned, blocks, s, comp, c, sync_bit, sync_out, rows,
                 nslots, wpl, LaneMajor{recs, width}, out_final);
  }
  return static_cast<int>(cudaGetLastError());
}
