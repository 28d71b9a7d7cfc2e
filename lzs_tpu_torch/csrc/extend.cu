// Run extension of the sort-based match search, over int32 (B, N) rows
// (N <= 32768): where a capped match (score == cap) runs on, how far.
//
//   ext_breaks  per position: capped = score >= cap && i + cap < n; a head
//               is a capped position whose predecessor is not capped or
//               has another offset; heads and uncapped positions are
//               breaks. A suffix min over the packed break info
//               (i << 13 | is_cap << 12 | off) finds the next break e
//               strictly after i, which pins the run's length (ext_res =
//               e - i - 1) unless the run touches the data end or a nearer
//               capped offset stole it (need_probe). Out: ext_res << 3 |
//               head << 2 | capped << 1 | need_probe.
//   ext_fold    a prefix max over the heads' packed (i << 16 | cap +
//               ext_h) hands each capped position its head; full = the
//               head's length minus the distance to it, score elsewhere.
//
// Replaces: lzs_tpu/ops/pext.py _break_kernel (K4) and _fold_kernel (K5),
// the Pallas roll scans with the same prologue and epilogue. The TPU
// kernels read i - 1 and i + 1 by rolling whole VMEM rows; here the
// predecessor comes straight from device memory (cached), and the
// successor's suffix min is the reverse scan's exclusive value. Past the
// row's end that value is MinOp's identity (INT_MAX) where JAX has
// 0x3FFFFFFF: both fail nxt1 < 0x3FFFFFFF, so the outputs are equal.
//
// Bound: memory. ext_breaks reads score and off and writes one plane (12
// bytes per element); ext_fold reads packed, score where not capped and
// ext_h at heads, and writes one plane (12-16 bytes per element).
//
// Design: both are the row-scan walk of rowscan.cu (lzs::row_scan, one
// CTA of 1024 threads per row) with the prologue fused into its load and
// the epilogue into its store.
#include "scan.cuh"

namespace {

constexpr int kBig = 0x3FFFFFFF;

struct BreaksIo {
  const int* score;
  const int* off;
  int* out;
  int n;      // the block's length
  int npos;   // the row's width
  int cap;
  // what load read at its element, for the store
  bool head = false;
  bool capped = false;
  int my_off = 0;

  __device__ int load(int i) {
    const int s = score[i];
    my_off = off[i];
    capped = s >= cap && i + cap < n;
    head = capped;
    if (capped && i > 0) {
      const bool prev_c = score[i - 1] >= cap && i - 1 + cap < n;
      head = !prev_c || my_off != off[i - 1];
    }
    if (capped && !head) return kBig;
    return (i << 13) | (static_cast<int>(s >= cap) << 12) |
           min(max(my_off, 0), 0x7FF);
  }

  __device__ void store(int i, int, int nxt1) const {
    const bool has_brk = nxt1 < kBig;
    const int e = has_brk ? nxt1 >> 13 : npos;
    const bool steal =
        has_brk && ((nxt1 >> 12) & 1) == 1 && (nxt1 & 0x7FF) < my_off;
    const bool need_probe = head && (e + cap >= n || steal);
    const unsigned ext_res = static_cast<unsigned>(e - i - 1);
    out[i] = static_cast<int>((ext_res << 3) |
                              (static_cast<unsigned>(head) << 2) |
                              (static_cast<unsigned>(capped) << 1) |
                              static_cast<unsigned>(need_probe));
  }
};

struct FoldIo {
  const int* packed;
  const int* ext_h;
  const int* score;
  int* out;
  int cap;
  int my_packed = 0;

  __device__ int load(int i) {
    my_packed = packed[i];
    if (((my_packed >> 2) & 1) == 0) return -1;
    return (i << 16) | min(cap + ext_h[i], 0xFFFF);
  }

  __device__ void store(int i, int pk, int) const {
    out[i] = ((my_packed >> 1) & 1) != 0 ? (pk & 0xFFFF) - (i - (pk >> 16))
                                         : score[i];
  }
};

__global__ void __launch_bounds__(lzs::kThreads)
ext_breaks_kernel(const int* __restrict__ score, const int* __restrict__ off,
                  const int* __restrict__ nb, int* __restrict__ out,
                  int npos, int cap) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * npos;
  BreaksIo io{score + row, off + row, out + row, nb[blockIdx.x], npos, cap};
  lzs::row_scan<lzs::MinOp, true>(npos, io);
}

__global__ void __launch_bounds__(lzs::kThreads)
ext_fold_kernel(const int* __restrict__ packed, const int* __restrict__ ext_h,
                const int* __restrict__ score, int* __restrict__ out,
                int npos, int cap) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * npos;
  FoldIo io{packed + row, ext_h + row, score + row, out + row, cap};
  lzs::row_scan<lzs::MaxOp, false>(npos, io);
}

}  // namespace

LZS_API int lzs_ext_breaks(const int* score, const int* off, const int* nb,
                           int* out, int rows, int npos, int cap, int device,
                           void* stream) {
  const lzs::DeviceGuard guard(device);
  ext_breaks_kernel<<<rows, lzs::kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(score, off, nb,
                                                           out, npos, cap);
  return static_cast<int>(cudaGetLastError());
}

LZS_API int lzs_ext_fold(const int* packed, const int* ext_h,
                         const int* score, int* out, int rows, int npos,
                         int cap, int device, void* stream) {
  const lzs::DeviceGuard guard(device);
  ext_fold_kernel<<<rows, lzs::kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(packed, ext_h, score,
                                                         out, npos, cap);
  return static_cast<int>(cudaGetLastError());
}
