// Lane-parallel token parse of container blocks: sync records -> packed
// token records.
//
//   recs[b, 4*s + k, l]  record of substep k of word step s of lane l
//                        (opos << 13 | is_copy << 11 | payload, or -1)
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
// 256 blocks of 32768 bytes, 0.015 ms at 3.35 TB/s).
//
// Design: one thread per (block, lane), lanes fastest, so that one step's
// record stores coalesce across the lanes of a block row; the state (two
// words, bit and output positions, mode, match offset) stays in registers
// for the whole walk. Each lane reads its own 4*wpl + 8 contiguous bytes,
// one word per step, through the read-only path: L1 keeps the 32-byte
// sector between the 8 steps that read it, so no shared-memory staging is
// needed (a CTA would also span two rows, since a row has L = 146 lanes at
// block 32768). The next step's word is loaded before the current step's
// substeps, which hides its latency. Every load address depends on
// (b, l, s) alone, never on the records, so corrupt records read nothing
// out of bounds. Where every row starts 4-byte aligned (C % 4 == 0 and an
// aligned base), a word is one load and a byte swap; else four bytes.
#include "scan.cuh"

namespace {

constexpr int kParseThreads = 64;
constexpr int kSubsteps = 4;   // tokens parseable per fed 32-bit word
constexpr int kMaxStepBits = 24;
constexpr int kExt = 15;       // MAX_EXTENDED_LENGTH

// int32 addition that wraps, as int32 does in JAX and in torch.
__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

// Word i of a row of c bytes that holds nwords words (see above).
template <bool kAligned>
__device__ __forceinline__ uint32_t load_word(const uint8_t* row, int64_t c,
                                              int64_t i, int64_t nwords) {
  if (i < 0 || i >= nwords) return 0u;
  const int64_t p = 4 * i;
  if (kAligned && p + 4 <= c) {
    return __byte_perm(__ldg(reinterpret_cast<const unsigned*>(row + p)), 0,
                       0x0123);
  }
  uint32_t w = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    w = (w << 8) | (p + k < c ? static_cast<uint32_t>(__ldg(row + p + k)) : 0u);
  }
  return w;
}

template <bool kAligned>
__global__ void __launch_bounds__(kParseThreads)
parse_lanes_kernel(const uint8_t* __restrict__ comp, int64_t c,
                   const int* __restrict__ sync_bit,
                   const int* __restrict__ sync_out, int rows, int nslots,
                   int wpl, int* __restrict__ recs,
                   int* __restrict__ out_final) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<int64_t>(rows) * nslots) return;
  const int64_t b = t / nslots;
  const int l = static_cast<int>(t - b * nslots);
  const uint8_t* row = comp + b * c;
  const int* sb = sync_bit + b * nslots;
  const int nsteps = wpl + 2;
  const int64_t nwords = static_cast<int64_t>(nslots) * wpl;
  const int64_t word0 = static_cast<int64_t>(l) * wpl - 1;
  int* rec_out =
      recs + b * (static_cast<int64_t>(nsteps) * kSubsteps * nslots) + l;

  const int so = sync_out[t];
  const int end_bit = sb[l + 1 < nslots ? l + 1 : l];
  int bitpos = sb[l];
  int outpos = so & 0x1FFFF;
  int mode = (so >> 17) & 1;
  int cur_off = so >> 18;            // arithmetic: JAX's int32 >>
  uint32_t hi = 0, lo = 0;
  uint32_t next = load_word<kAligned>(row, c, word0, nwords);

  for (int s = 0; s < nsteps; ++s) {
    hi = lo;
    lo = next;
    if (s + 1 < nsteps) {
      next = load_word<kAligned>(row, c, word0 + s + 1, nwords);
    }
    // bits fed so far (exclusive): (l*wpl - 1 + s + 1) * 32 in int32
    const int ebits = static_cast<int>(
        (static_cast<unsigned>(l) * static_cast<unsigned>(wpl) +
         static_cast<unsigned>(s)) * 32u);
    const int base = wrap_add(ebits, -64);
#pragma unroll
    for (int k = 0; k < kSubsteps; ++k) {
      const int d = wrap_add(bitpos, -base);
      const uint32_t sh = static_cast<uint32_t>(min(max(d, 0), 63));
      const uint32_t w =
          sh < 32 ? (hi << sh) | (sh == 0 ? 0u : lo >> (32 - sh))
                  : lo << (sh - 32);
      const bool can =
          bitpos < end_bit && wrap_add(bitpos, kMaxStepBits) <= ebits;

      // NORMAL: one token head
      const bool is_lit = (w >> 31) == 0;
      const int lit = static_cast<int>((w >> 23) & 0xFF);
      const bool short_off = ((w >> 30) & 1) != 0;
      const int n_off = static_cast<int>(short_off ? (w >> 23) & 0x7F
                                                   : (w >> 19) & 0x7FF);
      const int l4 = static_cast<int>(short_off ? (w >> 19) & 0xF
                                                : (w >> 15) & 0xF);
      const bool long_len = (l4 >> 2) == 3;
      const int len_init = long_len ? (l4 & 3) + 5 : (l4 >> 2) + 2;
      const int lw = long_len ? 4 : 2;
      const int n_len = is_lit ? 1 : len_init;
      const int n_consume = is_lit ? 9 : 1 + (short_off ? 8 : 12) + lw;
      const int n_mode = (!is_lit && long_len && (l4 & 3) == 3) ? 1 : 0;

      // EXTENDED: up to 6 nibbles (24 valid bits)
      const int nf = min(__clz(static_cast<int>(~w | 0xFFu)) >> 2, 6);
      const bool whole = nf >= 6;
      const int term = static_cast<int>((w >> (28 - 4 * min(nf, 5))) & 0xF);
      const int e_len = whole ? 6 * kExt : kExt * nf + term;
      const int e_consume = whole ? 24 : 4 * (nf + 1);
      const int e_mode = whole ? 1 : 0;

      const bool is_ext = mode == 1;
      const bool is_copy = is_ext || !is_lit;
      const int payload = is_ext ? cur_off : (is_lit ? lit : n_off);
      const int length = is_ext ? e_len : n_len;
      const int consume = is_ext ? e_consume : n_consume;
      const uint32_t packed = (static_cast<uint32_t>(outpos) << 13) |
                              (is_copy ? 1u << 11 : 0u) |
                              static_cast<uint32_t>(payload);
      rec_out[static_cast<int64_t>(s * kSubsteps + k) * nslots] =
          can && length > 0 ? static_cast<int>(packed) : -1;
      if (can) {
        bitpos = wrap_add(bitpos, consume);
        outpos = wrap_add(outpos, length);
        if (!is_ext && !is_lit) cur_off = n_off;
        mode = is_ext ? e_mode : n_mode;
      }
    }
  }
  out_final[t] = outpos;
}

}  // namespace

LZS_API int lzs_parse_lanes(const uint8_t* comp, const int* sync_bit,
                            const int* sync_out, int rows, int c, int nslots,
                            int wpl, int* recs, int* out_final, int device,
                            void* stream) {
  const lzs::DeviceGuard guard(device);
  const int64_t lanes = static_cast<int64_t>(rows) * nslots;
  const int blocks =
      static_cast<int>((lanes + kParseThreads - 1) / kParseThreads);
  const bool aligned =
      c % 4 == 0 && reinterpret_cast<uintptr_t>(comp) % 4 == 0;
  const auto s = static_cast<cudaStream_t>(stream);
  if (aligned) {
    parse_lanes_kernel<true><<<blocks, kParseThreads, 0, s>>>(
        comp, c, sync_bit, sync_out, rows, nslots, wpl, recs, out_final);
  } else {
    parse_lanes_kernel<false><<<blocks, kParseThreads, 0, s>>>(
        comp, c, sync_bit, sync_out, rows, nslots, wpl, recs, out_final);
  }
  return static_cast<int>(cudaGetLastError());
}
