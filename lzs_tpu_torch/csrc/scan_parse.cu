// Bit-serial parse of raw LZS streams (the raw decoder's engine "scan"):
// comp bytes -> one packed record per parse step.
//
//   recs[b, t]   step t's record: opos << 13 | is_copy << 11 | payload (a
//                literal's byte, a copy's offset), or -1 where the step
//                has no output (an end marker, a zero extension nibble, a
//                step after the stream is done)
//   out_len[b]   the stream's output count after its last step
//   markers[b]   the end markers it read
//
// Replaces: lzs_tpu/ops/decode.py _parse_scan, a lax.scan of max_units
// steps per stream (no Pallas kernel: XLA runs the scan on the TPU as one
// loop, the streams side by side under vmap). The state machine is the
// reference's (lzs-decompression.c:459-743) collapsed to two modes
// (normal, extended) and a done flag, with the single-call decoder's
// per-field input gates (lzs-decompression.c:214-343): a literal or an
// end marker needs 9 bits, a short-offset copy head 9 + its length field
// (2 or 4 bits), a long-offset one 13 + its length field, an extension
// nibble 4; a step with fewer bits left than its unit needs stops the
// stream. A copy head whose length code is 15 enters extended mode, where
// each nibble adds its value and a nibble of 15 stays there. An end
// marker consumes up to the next byte boundary and stops the stream
// unless multi_stream. Lengths are cut to out_cap - out_count, and the
// stream stops once its output reaches out_cap (so a stream of exactly
// out_cap bytes reads no end marker). Arithmetic is JAX's: int32.
//
// Bound: latency. Each stream is one chain of dependent steps (a step's
// bit position is the last step's plus its unit's width), so a stream is
// one thread and the kernel takes as long as its longest stream's steps.
// The bytes are few (C read once, 4 bytes of records per step).
//
// Design: one CTA of 128 threads per stream, so that a batch of 256
// streams spreads over the SMs and their L1s. Thread 0 walks the stream
// with the whole state in registers:
//   * The window is a 64-bit register of two big-endian words (word i is
//     bytes 4i..4i+3, zero at or past C: JAX reads 4 appended zero bytes
//     there) and one funnel shift at the bit position; a third word is
//     loaded one word ahead, so a refill (at most one per step: a step
//     consumes at most 17 bits) finds it in a register. Every load address
//     is bounded by C, whatever the bits say.
//   * A short-offset head is moved 4 bits down to the long-offset layout,
//     so that both read their offset and length fields at one place
//     (parse.cu's trick).
//   * One record store per step.
// When the stream is done, the CTA writes -1 over the rest of its row
// with coalesced stores (no memset launch).
#include "scan.cuh"

namespace {

constexpr int kScanThreads = 128;
constexpr int kExt = 15;       // MAX_EXTENDED_LENGTH

// Word i of a row of c bytes: bytes 4i..4i+3 big-endian, zero at or past
// c. An aligned row (c % 4 == 0, 4-byte aligned) holds a word whole or
// not at all: one load and a byte swap; else four byte loads.
template <bool kAligned>
__device__ __forceinline__ uint32_t word_at(const uint8_t* row, int64_t c,
                                            int64_t i) {
  const int64_t p = 4 * i;
  if (kAligned) {
    if (p >= c) return 0u;
    return __byte_perm(__ldg(reinterpret_cast<const unsigned*>(row + p)), 0,
                       0x0123);
  }
  uint32_t w = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    w = (w << 8) | (p + k < c ? static_cast<uint32_t>(__ldg(row + p + k)) : 0u);
  return w;
}

template <bool kAligned>
__global__ void __launch_bounds__(kScanThreads)
scan_parse_kernel(const uint8_t* __restrict__ comp, int64_t c,
                  const int* __restrict__ inbytes, int max_units,
                  int out_cap, bool multi_stream, int* __restrict__ recs,
                  int* __restrict__ out_len, int* __restrict__ markers) {
  const int64_t b = blockIdx.x;
  int* const rec = recs + b * max_units;
  __shared__ int steps_done;
  if (threadIdx.x == 0) {
    const uint8_t* row = comp + b * c;
    // JAX's inbytes * 8 in int32 (wraps)
    const int inbits =
        static_cast<int>(static_cast<unsigned>(__ldg(inbytes + b)) * 8u);
    int bitpos = 0, mode = 0, cur_off = 0, count = 0, mk = 0;
    int64_t wi = 0;                 // word of the window's top bit
    uint32_t hi = word_at<kAligned>(row, c, 0);
    uint32_t lo = word_at<kAligned>(row, c, 1);
    uint32_t ahead = word_at<kAligned>(row, c, 2);
    int t = 0;
    for (; t < max_units; ++t) {
      while (static_cast<int64_t>(bitpos) - 32 * wi >= 32) {
        ++wi;
        hi = lo;
        lo = ahead;
        ahead = word_at<kAligned>(row, c, wi + 2);
      }
      const int sh = static_cast<int>(bitpos - 32 * wi);
      const uint32_t w = static_cast<uint32_t>(
          ((static_cast<uint64_t>(hi) << 32 | lo) << sh) >> 32);
      const int rem = inbits - bitpos;
      int length, payload, consume;
      bool is_copy, marker = false;
      if (mode == 1) {            // EXTENDED: one length nibble
        if (rem < 4) break;
        length = static_cast<int>(w >> 28);
        payload = cur_off;
        consume = 4;
        is_copy = true;
        mode = length == kExt;
      } else {                    // NORMAL: one head
        const bool is_lit = static_cast<int>(w) >= 0;
        const bool short_off = ((w >> 30) & 1) != 0;
        const uint32_t v = short_off ? w >> 4 : w;
        const int off =
            static_cast<int>((v >> 19) & (short_off ? 0x7Fu : 0x7FFu));
        const int l4 = static_cast<int>((v >> 15) & 0xF);
        const bool long_len = l4 >= 12;
        marker = !is_lit && short_off && off == 0;
        const int need = is_lit || marker
                             ? 9
                             : (short_off ? 11 : 15) + (long_len ? 2 : 0);
        if (rem < need) break;
        is_copy = !is_lit;
        if (is_lit) {
          length = 1;
          payload = static_cast<int>((w >> 23) & 0xFF);
          consume = 9;
        } else if (marker) {
          length = 0;
          payload = 0;
          consume = ((bitpos + 16) & ~7) - bitpos;
          ++mk;
        } else {
          length = long_len ? (l4 & 3) + 5 : (l4 >> 2) + 2;
          payload = off;
          consume = need;
          cur_off = off;
          mode = l4 == 15;
        }
      }
      length = min(length, out_cap - count);
      rec[t] = length > 0
                   ? static_cast<int>(static_cast<unsigned>(count) << 13 |
                                      (is_copy ? 1u << 11 : 0u) |
                                      static_cast<unsigned>(payload))
                   : -1;
      bitpos += consume;
      count += length;
      if (count >= out_cap || (marker && !multi_stream)) {
        ++t;
        break;
      }
    }
    steps_done = t;
    out_len[b] = count;
    markers[b] = mk;
  }
  __syncthreads();
  for (int t = steps_done + threadIdx.x; t < max_units; t += kScanThreads)
    rec[t] = -1;
}

}  // namespace

LZS_API int lzs_scan_parse(const uint8_t* comp, const int* inbytes, int rows,
                           int c, int max_units, int out_cap, int multi_stream,
                           int* recs, int* out_len, int* markers, int device,
                           void* stream) {
  const lzs::DeviceGuard guard(device);
  if (rows < 1 || c < 0 || max_units < 0 || out_cap < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const bool aligned =
      c % 4 == 0 && reinterpret_cast<uintptr_t>(comp) % 4 == 0;
  if (aligned) {
    scan_parse_kernel<true><<<rows, kScanThreads, 0, s>>>(
        comp, c, inbytes, max_units, out_cap, multi_stream != 0, recs,
        out_len, markers);
  } else {
    scan_parse_kernel<false><<<rows, kScanThreads, 0, s>>>(
        comp, c, inbytes, max_units, out_cap, multi_stream != 0, recs,
        out_len, markers);
  }
  return static_cast<int>(cudaGetLastError());
}
