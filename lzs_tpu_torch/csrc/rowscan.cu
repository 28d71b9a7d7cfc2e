// Row scans over int32 (B, N): inclusive prefix max, suffix min and
// prefix sum, and the exclusive count of a bool mask.
//
// Replaces: lzs_tpu/ops/pext.py _cummax_kernel (K8, cummax_rows),
// _rcummin_kernel (K7, rcummin_rows), _cumsum_kernel (K9,
// cumsum_rows_wide) and _rank_kernel (K6, rank_mask), the Pallas log-step
// roll scans. K9's two-stage
// tiling (per-tile scans, a cumsum of tile totals, a broadcast add)
// exists only because a TPU row must fit VMEM; the carry below does the
// same in one launch for any width.
//
// Bound: memory. Each element is read once and written once (8 bytes; 5
// for the mask's count); the scan itself is a few integer operations per
// element.
//
// Design: one CTA of 1024 threads per row, walked by lzs::row_scan
// (scan.cuh): tiles of 1024 consecutive elements (coalesced 4-byte loads
// and stores, one per thread), each scanned across the CTA with warp
// shuffles and one warp over the 32 warp totals, a carry threading the
// tiles together. The suffix scan walks the tiles from the row's end with
// the thread order reversed. Any N works (encode rows are 32768, the
// decoder's filled-record rows 38656, the raw decoder's slot rows 33792);
// the ragged last tile pads with the operator's identity. The sum wraps
// modulo 2^32 like an int32 sum in torch. The match search's fused scans
// (cand.cu, extend.cu) are other load/store policies of the same walk.
#include "scan.cuh"

namespace {

// Scans the row as it is and stores the inclusive scan.
struct PlainIo {
  const int* src;
  int* dst;
  __device__ int load(int idx) const { return src[idx]; }
  __device__ void store(int idx, int incl, int) const { dst[idx] = incl; }
};

// Counts the set entries of a bool row and stores the exclusive count.
struct RankIo {
  const unsigned char* mask;
  int* dst;
  __device__ int load(int idx) const { return mask[idx] != 0; }
  __device__ void store(int idx, int, int excl) const { dst[idx] = excl; }
};

__global__ void __launch_bounds__(lzs::kThreads)
rank_mask_kernel(const unsigned char* __restrict__ mask, int* __restrict__ out,
                 int n) {
  const int64_t row = blockIdx.x;
  RankIo io{mask + row * n, out + row * n};
  lzs::row_scan<lzs::AddOp, false>(n, io);
}

template <class Op, bool Reverse>
__global__ void __launch_bounds__(lzs::kThreads)
rowscan_kernel(const int* __restrict__ in, int* __restrict__ out, int n) {
  const int64_t row = blockIdx.x;
  PlainIo io{in + row * n, out + row * n};
  lzs::row_scan<Op, Reverse>(n, io);
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

LZS_API int lzs_rank_mask_rows(const unsigned char* mask, int* out, int rows,
                               int n, int device, void* stream) {
  const lzs::DeviceGuard guard(device);
  rank_mask_kernel<<<rows, lzs::kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(mask, out, n);
  return static_cast<int>(cudaGetLastError());
}

LZS_API const char* lzs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
