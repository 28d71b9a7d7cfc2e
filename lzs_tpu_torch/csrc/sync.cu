// Decode-sync records: the parser state at the last parse step before
// every multiple of `span` compressed bits, stored straight into its slot.
//
// Replaces: lzs_tpu/ops/psync.py _sync_kernel (K16: owner cummax,
// parse-step predicate, next-step reverse cummin, span-crossing keys) and
// the three compaction sorts after it in lzs_tpu/ops/encode.py
// _sync_records_batch. A parse step is at most 24 bits < span, so each
// boundary span*c has exactly one crossing step: slot c is a store.
//
// Bound: memory and latency. Four int32 rows are read (16 bytes per
// position); the output is two slot rows of a few hundred entries.
//
// Design: one CTA of 1024 threads per block row, two passes over the row.
// Pass 1 walks tiles forward and keeps the owner-token cummax
// (start << 12 | clipped offset) of every position in shared memory
// (4 bytes per position: 128 KB at block 32768). Pass 2 walks tiles from
// the row's end: each position decides whether it is a parse step (a
// token head, or every `nibbles`-th extension nibble), the suffix min of
// step offsets (seeded with end_bits, the bit after the last step) gives
// the next step's offset, and a step whose successor lies past a span
// boundary c < nsync stores its record in slot c. Slot 0 is the stream
// start, slots >= nsync the sentinel (end_bits, n). JAX's // and % floor;
// floor_div / floor_mod mirror them. The record keeps the TPU kernel's
// 0xFFF offset clip and 29 record bits.
#include "scan.cuh"

namespace {

constexpr int kBig = 0x3FFFFFFF;
constexpr int kRecMask = 0x1FFFFFFF;

__global__ void __launch_bounds__(lzs::kThreads)
sync_kernel(const int* __restrict__ starts, const int* __restrict__ width,
            const int* __restrict__ off, const int* __restrict__ offs,
            const int* __restrict__ end_bits, const int* __restrict__ n,
            int npos, int span, int nibbles, int short_len, int ext_len,
            int nslots, int* __restrict__ sync_bit,
            int* __restrict__ sync_out, int* __restrict__ nsync) {
  extern __shared__ int okey[];
  __shared__ int warp_tot[32];
  const int64_t row = blockIdx.x;
  const int* st = starts + row * npos;
  const int* wd = width + row * npos;
  const int* of = off + row * npos;
  const int* os = offs + row * npos;
  const int eb = end_bits[row];
  const int ns = lzs::floor_div(eb + span - 1, span);
  int* sb = sync_bit + row * nslots;
  int* so = sync_out + row * nslots;

  for (int s = threadIdx.x; s < nslots; s += blockDim.x) {
    const bool live = s < ns;
    sb[s] = live ? 0 : eb;
    so[s] = live ? 0 : n[row];
  }

  // pass 1: owner-token cummax (start index << 12 | clipped offset)
  int carry = lzs::MaxOp::identity;
  for (int base = 0; base < npos; base += blockDim.x) {
    const int i = base + threadIdx.x;
    int v = lzs::MaxOp::identity;
    if (i < npos) v = st[i] ? ((i << 12) | min(of[i], 0xFFF)) : -1;
    int excl, total;
    const int s = lzs::block_scan(v, lzs::MaxOp{}, warp_tot, &excl, &total);
    if (i < npos) okey[i] = max(carry, s);
    carry = max(carry, total);
  }
  __syncthreads();

  // pass 2, from the row's end: parse steps, next step, crossings
  carry = eb;
  for (int base = 0; base < npos; base += blockDim.x) {
    const int k = base + threadIdx.x;
    const int i = npos - 1 - k;
    bool step = false;
    int o = 0, rec = 0, v = lzs::MinOp::identity;
    if (k < npos) {
      const bool head = st[i] != 0;
      const int key = okey[i];
      const int owner_i = key >> 12;
      const int owner_off = key & 0xFFF;
      const int t = i - owner_i - 1;
      const bool nib = !head && wd[i] == 4;
      step = head || (nib && lzs::floor_mod(t, nibbles) == 0);
      o = os[i];
      const int opos = head ? i : owner_i + short_len + ext_len * t;
      rec = head ? i : (opos | (1 << 17) | (owner_off << 18));
      v = step ? o : kBig;
    }
    int excl, total;
    lzs::block_scan(v, lzs::MinOp{}, warp_tot, &excl, &total);
    if (step) {
      const int c = lzs::floor_div(min(carry, excl), span);
      if (lzs::floor_div(o, span) < c && c < ns) {
        sb[c] = o;
        so[c] = rec & kRecMask;
      }
    }
    carry = min(carry, total);
  }
  if (threadIdx.x == 0) nsync[row] = ns;
}

}  // namespace

LZS_API int lzs_sync_rows(const int* starts, const int* width, const int* off,
                          const int* offs, const int* end_bits, const int* n,
                          int rows, int npos, int span, int nibbles,
                          int short_len, int ext_len, int nslots,
                          int* sync_bit, int* sync_out, int* nsync,
                          int device, void* stream) {
  const lzs::DeviceGuard guard(device);
  const size_t smem = static_cast<size_t>(npos) * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      sync_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  sync_kernel<<<rows, lzs::kThreads, smem,
                static_cast<cudaStream_t>(stream)>>>(
      starts, width, off, offs, end_bits, n, npos, span, nibbles, short_len,
      ext_len, nslots, sync_bit, sync_out, nsync);
  return static_cast<int>(cudaGetLastError());
}
