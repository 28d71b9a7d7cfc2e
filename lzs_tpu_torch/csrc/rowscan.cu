// Row scans over int32 (B, N): inclusive prefix max, suffix min and
// prefix sum, and the exclusive count of a bool mask.
//
// Replaces: lzs_tpu/ops/pext.py _cummax_kernel (K8, cummax_rows),
// _rcummin_kernel (K7, rcummin_rows), _cumsum_kernel (K9,
// cumsum_rows_wide) and _rank_kernel (K6, rank_mask), the Pallas log-step
// roll scans. K9's two-stage
// tiling (per-tile scans, a cumsum of tile totals, a broadcast add)
// exists only because a TPU row must fit VMEM; the chain below does the
// same in one launch for any width.
//
// Bound: memory. Each element is read once and written once (8 bytes; 5
// for the mask's count); the scan itself is a few integer operations per
// element.
//
// Design (K6, rank_mask_kernel): one CTA of 1024 threads per row, walked
// by lzs::row_scan (scan.cuh): tiles of 1024 consecutive elements, each
// scanned across the CTA, a carry threading the tiles together (the last
// kernel on this walk).
//
// Design (K7-K9, chain_scan_kernel: one template, instantiated as sum
// forward (K9), max forward (K8) and min backward (K7)): the callers give
// many rows (the raw decoder's 1024 x 75776 chain rows and 256 x 33792
// slot rows, the encoder's 256 x 32768, the filled records' 256 x 38656)
// and few (four 200704-wide chain rows and one 89216-slot row per 2^18
// decode_block), so a row is not a CTA's: every CTA takes one tile of a
// row, and the tiles chain their partial results in one pass (a scan with
// decoupled look-back). A max, a min and a wrapping sum chain alike; each
// starts from its operator's identity (INT_MIN, INT_MAX, 0), which also
// pads the row's ragged end. The kernel is lzs::chain_scan_kernel of
// chain.cuh (its comment has the design), through CopyIo: each group of
// 4 is read from `in` (one 16-byte load where the row is aligned) and its
// scan written to `out`. K4 and K5 (extend.cu) are other policies of the
// same kernel.
#include "chain.cuh"

namespace {

// K7-K9: read `in`, write `out`; nothing kept between load and store.
struct CopyIo {
  const int* in;
  int* out;
  struct Kept {};
  static constexpr int kPlanes = 0;
  static constexpr bool kExclusive = false;

  __device__ __forceinline__ CopyIo bind(int64_t) const { return *this; }

  __device__ __forceinline__ void load(int64_t at, int, bool vec, int count,
                                       int pad, int* v, Kept&, const int4*,
                                       int) const {
    if (vec) {
      const int4 w4 = __ldg(reinterpret_cast<const int4*>(in + at));
      v[0] = w4.x;
      v[1] = w4.y;
      v[2] = w4.z;
      v[3] = w4.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = j < count ? __ldg(in + at + j) : pad;
    }
  }

  __device__ __forceinline__ void store(int64_t at, int, bool vec, int count,
                                        const int* s, const Kept&,
                                        const int4*, int) const {
    if (vec) {
      *reinterpret_cast<int4*>(out + at) = make_int4(s[0], s[1], s[2], s[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (j < count) out[at + j] = s[j];
    }
  }
};

template <class Op, bool kReverse>
int chain_rows(const int* in, int* out, int rows, int n, int tile,
               void* words, int capacity, int device, void* stream) {
  const bool vec = n % 4 == 0 && lzs::aligned16(in) && lzs::aligned16(out);
  return lzs::chain_rows<Op, kReverse>(CopyIo{in, out}, vec, rows, n, tile,
                                       words, capacity, device, stream);
}

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

}  // namespace

LZS_API int lzs_cummax_rows(const int* in, int* out, int rows, int n,
                            int tile, void* words, int capacity, int device,
                            void* stream) {
  return chain_rows<lzs::MaxOp, false>(in, out, rows, n, tile, words,
                                       capacity, device, stream);
}

LZS_API int lzs_rcummin_rows(const int* in, int* out, int rows, int n,
                             int tile, void* words, int capacity, int device,
                             void* stream) {
  return chain_rows<lzs::MinOp, true>(in, out, rows, n, tile, words,
                                      capacity, device, stream);
}

LZS_API int lzs_cumsum_rows(const int* in, int* out, int rows, int n,
                            int tile, void* words, int capacity, int device,
                            void* stream) {
  return chain_rows<lzs::AddOp, false>(in, out, rows, n, tile, words,
                                       capacity, device, stream);
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
