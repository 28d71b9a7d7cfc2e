// Per-k glue of the sort-based match search, over int32 (B, N) rows of
// sorted ranks (N <= 32768): for each match length k the keys that a row
// sort groups into k-segments, and the fold of the sorted keys into the
// packed running best match.
//
//   perk_keys      keys[i] = (cummax_{j <= i}(plcp[j] < k ? j : 0) << 15)
//                  | p[i]: the segment head of every rank and its position.
//   perk_back_acc  on the row-sorted keys: slot j's predecessor in the same
//                  segment, if it lies within the window, is the nearest
//                  earlier occurrence of the k-gram at mypos = skey[j] &
//                  0x7FFF; out[mypos] = max(pk[mypos], hit ? k << 16 |
//                  32768 - (mypos - cand) : -1).
//
// Replaces: lzs_tpu/ops/pcand.py _keys_kernel (K1), _back_kernel (K2) and
// _acc_kernel (K3). The TPU kernels scan by log-step rolls in VMEM, and
// put K2's output back in position order with a second row sort before
// K3 reads it. Here the positions of one row's sorted keys are a
// permutation of 0..N-1 (p holds every position, padding included), so
// perk_back_acc stores each slot's result straight at its position: every
// output element has exactly one writer, and K3 fuses into K2's store.
//
// Bound: memory. perk_keys reads plcp and p and writes the keys (12 bytes
// per element); perk_back_acc reads skey (its predecessor again, from
// cache) and pk and writes the result (12 bytes per element).
//
// Design: one CTA of 1024 threads per row. perk_keys is the row-scan walk
// of rowscan.cu (lzs::row_scan) with the compare fused into its load and
// the pack into its store. perk_back_acc copies the row of pk into shared
// memory (at most 128 KiB), strides the sorted slots one per thread and
// updates the shared row at each slot's position, then writes the row
// out: every device-memory access is coalesced, and only the shared row
// is read and written in scattered order. (Stored straight to device
// memory, those scattered 4-byte accesses cost 0.46 ms per level at 256 x
// 32768 on an H100, 15 times the bound.) The output never aliases pk: a
// caller may keep the accumulator of every level.
#include "scan.cuh"

namespace {

struct KeysIo {
  const int* plcp;
  const int* p;
  int* keys;
  int k;
  __device__ int load(int idx) const { return plcp[idx] < k ? idx : 0; }
  __device__ void store(int idx, int seg, int) const {
    keys[idx] = (seg << 15) | p[idx];
  }
};

__global__ void __launch_bounds__(lzs::kThreads)
perk_keys_kernel(const int* __restrict__ plcp, const int* __restrict__ p,
                 int* __restrict__ keys, int n, int k) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * n;
  KeysIo io{plcp + row, p + row, keys + row, k};
  lzs::row_scan<lzs::MaxOp, false>(n, io);
}

// Dynamic shared memory: int[n], the row of the running best.
__global__ void __launch_bounds__(lzs::kThreads)
perk_back_acc_kernel(const int* __restrict__ skey, const int* __restrict__ nb,
                     const int* __restrict__ pk, int* __restrict__ out,
                     int n, int k, int window) {
  extern __shared__ int acc[];
  const int64_t row = static_cast<int64_t>(blockIdx.x) * n;
  const int limit = nb[blockIdx.x];
  const int* sk = skey + row;
  for (int j = threadIdx.x; j < n; j += blockDim.x) acc[j] = pk[row + j];
  __syncthreads();
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const int key = sk[j];
    const int prev = j > 0 ? sk[j - 1] : -1;
    const int mypos = key & 0x7FFF;
    const int prevpos = prev & 0x7FFF;
    const bool same = (key >> 15) == (prev >> 15);
    const int cand = same && mypos - prevpos <= window ? prevpos : -1;
    const bool hit = cand >= 0 && mypos + k <= limit;
    const int val = hit ? (k << 16) | (32768 - (mypos - cand)) : -1;
    acc[mypos] = max(acc[mypos], val);   // the one writer of this position
  }
  __syncthreads();
  for (int j = threadIdx.x; j < n; j += blockDim.x) out[row + j] = acc[j];
}

}  // namespace

LZS_API int lzs_perk_keys(const int* plcp, const int* p, int* keys, int rows,
                          int n, int k, int device, void* stream) {
  const lzs::DeviceGuard guard(device);
  perk_keys_kernel<<<rows, lzs::kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(plcp, p, keys, n,
                                                          k);
  return static_cast<int>(cudaGetLastError());
}

LZS_API int lzs_perk_back_acc(const int* skey, const int* nb, const int* pk,
                              int* out, int rows, int n, int k, int window,
                              int device, void* stream) {
  const lzs::DeviceGuard guard(device);
  const size_t smem = static_cast<size_t>(n) * sizeof(int);
  const cudaError_t err = cudaFuncSetAttribute(
      perk_back_acc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  perk_back_acc_kernel<<<rows, lzs::kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      skey, nb, pk, out, n, k, window);
  return static_cast<int>(cudaGetLastError());
}
