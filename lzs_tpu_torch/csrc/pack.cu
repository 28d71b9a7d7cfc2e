// Bit pack: per-position (value, width) units -> big-endian stream bytes.
//
// Replaces: lzs_tpu/ops/ppack.py _phase1_kernel (K14: exclusive bit-offset
// cumsum, 64-bit anchored windows, segmented suffix-OR) and _phase2_kernel
// (K15: spill merge, head-compaction keys), together with the two
// head-compaction sorts and the end-marker splice of
// lzs_tpu/ops/bitpack.py pack_bits_batch. The sorts existed only because
// XLA scatters serialize on a TPU.
//
// Bound: memory and latency. Per unit: 8 bytes read, 4 bytes of offset
// written, about one byte of stream written; the row's words never leave
// the SM until they are final.
//
// Design: one CTA of 1024 threads per block row. The row's output words
// (cap_bytes / 4, 9219 words = 36 KB at block 32768) live in shared
// memory. Tiles of 1024 units are scanned across the CTA for the
// exclusive bit offsets (stored: the sync-record builder reads them);
// each live unit ORs the two halves of its 64-bit window into words w0
// and w0 + 1 with shared-memory atomics (units never share bits, so OR
// is the reference's bit-queue append, lzs-compression.c:303-313). Then
// the end marker is spliced in, words past the stream are zeroed, and
// the words leave as big-endian bytes in coalesced 4-byte stores.
#include "scan.cuh"

namespace {

__device__ __forceinline__ int clip(int s) {
  return s < 0 ? 0 : (s > 31 ? 31 : s);
}

// The 64-bit big-endian window of a `width`-bit field v starting at bit
// `start`: word index w0, high half, low half (uint32 arithmetic and shift
// clipping exactly as the TPU kernel has them).
__device__ __forceinline__ void window(unsigned v, int start, int width,
                                       int* w0, unsigned* hi, unsigned* lo) {
  *w0 = start >> 5;
  const int end = (start & 31) + width;
  if (end <= 32) {
    *hi = v << clip(32 - end);
    *lo = 0u;
  } else {
    *hi = v >> clip(end - 32);
    *lo = v << clip(64 - end);
  }
}

__device__ __forceinline__ void or_word(unsigned* words, int cap_words,
                                        int w, unsigned bits) {
  if (bits && w >= 0 && w < cap_words) atomicOr(&words[w], bits);
}

__global__ void __launch_bounds__(lzs::kThreads)
pack_kernel(const int* __restrict__ value, const int* __restrict__ width,
            int m, uint8_t* __restrict__ comp, int cap_bytes,
            int* __restrict__ total_bits, int* __restrict__ offs,
            unsigned end_value, int end_bits, int use_end) {
  extern __shared__ unsigned words[];
  __shared__ int warp_tot[32];
  const int cap_words = cap_bytes >> 2;
  const int64_t row = blockIdx.x;
  const int* vrow = value + row * m;
  const int* wrow = width + row * m;
  int* orow = offs + row * m;

  for (int i = threadIdx.x; i < cap_words; i += blockDim.x) words[i] = 0u;
  __syncthreads();

  int carry = 0;
  for (int base = 0; base < m; base += blockDim.x) {
    const int k = base + threadIdx.x;
    const int w = k < m ? wrow[k] : 0;
    int excl, total;
    lzs::block_scan(w, lzs::AddOp{}, warp_tot, &excl, &total);
    if (k < m) {
      const int o = carry + excl;
      orow[k] = o;
      if (w > 0) {
        int w0;
        unsigned hi, lo;
        window(static_cast<unsigned>(vrow[k]), o, w, &w0, &hi, &lo);
        or_word(words, cap_words, w0, hi);
        or_word(words, cap_words, w0 + 1, lo);
      }
    }
    carry += total;
  }
  __syncthreads();

  int tb = carry;
  if (use_end) {
    if (threadIdx.x == 0) {
      int w0;
      unsigned hi, lo;
      window(end_value, tb, end_bits, &w0, &hi, &lo);
      or_word(words, cap_words, w0, hi);
      or_word(words, cap_words, w0 + 1, lo);
    }
    tb += end_bits;
  }
  __syncthreads();

  const int nwords = (tb + 31) >> 5;
  uint32_t* out = reinterpret_cast<uint32_t*>(comp + row * cap_bytes);
  for (int i = threadIdx.x; i < cap_words; i += blockDim.x) {
    const unsigned x = i < nwords ? words[i] : 0u;
    out[i] = __byte_perm(x, 0u, 0x0123);  // big-endian byte order
  }
  if (threadIdx.x == 0) total_bits[row] = tb;
}

}  // namespace

LZS_API int lzs_pack_rows(const int* value, const int* width, int rows, int m,
                          uint8_t* comp, int cap_bytes, int* total_bits,
                          int* offs, int end_value, int end_bits, int use_end,
                          int device, void* stream) {
  const lzs::DeviceGuard guard(device);
  const size_t smem = static_cast<size_t>(cap_bytes >> 2) * sizeof(unsigned);
  cudaError_t err = cudaFuncSetAttribute(
      pack_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  pack_kernel<<<rows, lzs::kThreads, smem,
                static_cast<cudaStream_t>(stream)>>>(
      value, width, m, comp, cap_bytes, total_bits, offs,
      static_cast<unsigned>(end_value), end_bits, use_end);
  return static_cast<int>(cudaGetLastError());
}
