// Row scans over int32 (B, N): inclusive prefix max, suffix min and
// prefix sum.
//
// Replaces: lzs_tpu/ops/pext.py _cummax_kernel (K8, cummax_rows),
// _rcummin_kernel (K7, rcummin_rows) and _cumsum_kernel (K9,
// cumsum_rows_wide), the Pallas log-step roll scans. K9's two-stage
// tiling (per-tile scans, a cumsum of tile totals, a broadcast add)
// exists only because a TPU row must fit VMEM; the carry below does the
// same in one launch for any width.
//
// Bound: memory. Each element is read once and written once (8 bytes);
// the scan itself is a few integer operations per element.
//
// Design: one CTA of 1024 threads per row. The row is walked in tiles of
// 1024 consecutive elements (coalesced 4-byte loads and stores, one per
// thread); each tile is scanned across the CTA with warp shuffles and one
// warp over the 32 warp totals, and a carry threads the tiles together.
// The suffix scan walks the tiles from the row's end with the thread
// order reversed. Any N works (encode rows are 32768, the decoder's
// filled-record rows 38656, the raw decoder's slot rows 33792); the
// ragged last tile pads with the operator's identity. The sum wraps
// modulo 2^32 like an int32 sum in torch.
#include "scan.cuh"

namespace {

template <class Op, bool Reverse>
__global__ void __launch_bounds__(lzs::kThreads)
rowscan_kernel(const int* __restrict__ in, int* __restrict__ out, int n) {
  __shared__ int warp_tot[32];
  const Op op{};
  const int64_t row = blockIdx.x;
  const int* src = in + row * n;
  int* dst = out + row * n;
  int carry = Op::identity;
  for (int base = 0; base < n; base += blockDim.x) {
    const int k = base + threadIdx.x;
    const int idx = Reverse ? n - 1 - k : k;
    const int v = k < n ? src[idx] : Op::identity;
    int excl, total;
    const int s = lzs::block_scan(v, op, warp_tot, &excl, &total);
    if (k < n) dst[idx] = op(carry, s);
    carry = op(carry, total);
  }
}

template <class Op, bool Reverse>
int launch(const int* in, int* out, int rows, int n, int device,
           cudaStream_t stream) {
  const lzs::DeviceGuard guard(device);
  rowscan_kernel<Op, Reverse><<<rows, lzs::kThreads, 0, stream>>>(in, out, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

LZS_API int lzs_cummax_rows(const int* in, int* out, int rows, int n,
                            int device, void* stream) {
  return launch<lzs::MaxOp, false>(in, out, rows, n, device,
                                   static_cast<cudaStream_t>(stream));
}

LZS_API int lzs_rcummin_rows(const int* in, int* out, int rows, int n,
                             int device, void* stream) {
  return launch<lzs::MinOp, true>(in, out, rows, n, device,
                                  static_cast<cudaStream_t>(stream));
}

LZS_API int lzs_cumsum_rows(const int* in, int* out, int rows, int n,
                            int device, void* stream) {
  return launch<lzs::AddOp, false>(in, out, rows, n, device,
                                   static_cast<cudaStream_t>(stream));
}

LZS_API const char* lzs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
