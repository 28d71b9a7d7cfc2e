// LZ77 copy expansion: filled parse records -> decoded bytes + status.
//
// Replaces: lzs_tpu/ops/pexpand.py _expand_rec_kernel (K17: record walk
// by binary search over a 768-slot record window, a carried 2 KiB
// circular byte window with two-level gathers, 6 in-chunk doubling
// rounds, status bits 0-1).
//
// Bound: latency. Each byte needs its covering record (a dependent chain
// of ~16 cached loads) and, for a copy, its source byte, which may be a
// byte of the same chunk that is not resolved yet. Bytes written: one per
// output byte; the record row is read through the cache.
//
// Design: one CTA of 1024 threads per block row, the whole decoded row in
// shared memory where it fits (32 KiB at block 32768; up to the card's
// opt-in limit less 8 KiB, 219 KiB on an H100), so the TPU kernel's
// carried circular window and its gathers become plain reads of bytes
// already written. A wider row (the raw decoder allows 2^18 bytes) is read
// back from the output row in device memory instead: the same CTA wrote
// it in earlier chunks, and __syncthreads() makes those writes visible.
// A window would not do: a long copy's sources lie in [seg - d, seg),
// which can be many chunks back. Where both fit, the shared-memory row is
// the faster: 0.194 against 0.199 ms for 256 rows of 32768 bytes (NVIDIA
// H100 80GB HBM3, 700 W; spread 0.001 ms). The row is walked in chunks of
// 1024 bytes, one byte per thread:
//   * the covering record is the last slot whose output position is <= j,
//     found by a power-of-two binary search over the filled record row
//     (nondecreasing), the same search the plain version runs;
//   * a literal gives its byte; a copy of offset d starting at s reads
//     s - d + (j - s) mod d, which is strictly before s: a source before
//     the chunk is final (in shared memory, or in the output row; a
//     source past n is written there as 0, but then so is the byte that
//     reads it), a source before the block start is 0 (status bit 1);
//   * sources inside the chunk resolve by pointer doubling over shared
//     memory until every byte of the chunk is resolved (chains are at
//     at most 1023 deep, so at most 11 rounds).
// Status bit 0 marks a byte in [0, n) with no covering record; such a
// byte also sets bit 1, as in the TPU kernel.
#include "scan.cuh"

namespace {

__global__ void __launch_bounds__(lzs::kThreads)
expand_kernel(const int* __restrict__ recfill, const int* __restrict__ n,
              int s, uint8_t* __restrict__ out, int out_cap,
              int* __restrict__ status, bool row_in_smem) {
  extern __shared__ int smem[];
  int* cval = smem;                    // resolved << 8 | byte, per thread
  int* cptr = smem + blockDim.x;       // in-chunk source, per thread
  unsigned char* obuf = reinterpret_cast<unsigned char*>(smem + 2 * blockDim.x);
  const int64_t row = blockIdx.x;
  const int* rrow = recfill + row * s;
  uint8_t* orow = out + row * out_cap;
  const int nb = n[row];
  const int top = 1 << (31 - __clz(s));
  int bad = 0;

  for (int base = 0; base < out_cap; base += blockDim.x) {
    const int j = base + threadIdx.x;
    int packed = 1 << 8;               // resolved, byte 0
    int p = threadIdx.x;
    if (j < out_cap) {
      int lo = -1;
      for (int step = top; step > 0; step >>= 1) {
        const int probe = lo + step;
        if (probe < s) {
          const int r = rrow[probe];
          if ((r >= 0 ? r >> 13 : -1) <= j) lo = probe;
        }
      }
      const int rec = lo >= 0 ? rrow[lo] : -1;
      if (rec < 0) {
        if (j < nb) bad |= 3;   // the TPU kernel's -1 record is also a
                                // copy from before the block start
      } else if (((rec >> 11) & 1) == 0) {
        packed = (1 << 8) | (rec & 0xFF);
      } else {
        const int seg = rec >> 13;
        const int d = max(rec & 0x7FF, 1);
        const int src = seg - d + (j - seg) % d;
        if (src < 0) {
          if (j < nb) bad |= 2;
        } else if (src < base) {
          packed = (1 << 8) | (row_in_smem ? obuf[src] : __ldcg(orow + src));
        } else {
          packed = 0;
          p = src - base;
        }
      }
    }
    cval[threadIdx.x] = packed;
    cptr[threadIdx.x] = p;
    bool done = (packed >> 8) != 0;
    // every unresolved byte points strictly back inside the chunk, so
    // log2(1024) + 1 rounds resolve all; the bound only guards the loop
    for (int round = 0; round < 32 && __syncthreads_or(!done); ++round) {
      int nv = packed, np = p;
      if (!done) {
        const int g = cval[p];
        if (g >> 8) nv = g;
        else np = cptr[p];
      }
      __syncthreads();
      if (!done) {
        packed = nv;
        p = np;
        cval[threadIdx.x] = nv;
        cptr[threadIdx.x] = np;
        done = (nv >> 8) != 0;
      }
    }
    if (j < out_cap) {
      const unsigned char v = static_cast<unsigned char>(packed & 0xFF);
      if (row_in_smem) obuf[j] = v;
      orow[j] = j < nb ? v : 0;
    }
    __syncthreads();
  }
  const int b0 = __syncthreads_or(bad & 1);
  const int b1 = __syncthreads_or(bad & 2);
  if (threadIdx.x == 0) status[row] = (b0 ? 1 : 0) | (b1 ? 2 : 0);
}

}  // namespace

LZS_API int lzs_expand_rows(const int* recfill, const int* n, int rows, int s,
                            uint8_t* out, int out_cap, int* status,
                            int device, void* stream) {
  const lzs::DeviceGuard guard(device);
  int optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t chunk_smem = 2 * lzs::kThreads * sizeof(int);
  const bool row_in_smem =
      chunk_smem + static_cast<size_t>(out_cap) <= static_cast<size_t>(optin);
  const size_t smem = chunk_smem + (row_in_smem ? out_cap : 0);
  err = cudaFuncSetAttribute(
      expand_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  expand_kernel<<<rows, lzs::kThreads, smem,
                  static_cast<cudaStream_t>(stream)>>>(
      recfill, n, s, out, out_cap, status, row_in_smem);
  return static_cast<int>(cudaGetLastError());
}
