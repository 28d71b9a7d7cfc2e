// Batched gather from wide per-row int32 tables:
//
//   out[b, q] = tab[b, clamp(idx[b, q], 0, w - 1)]   tab (B, W), idx (B, Q)
//
// Replaces: lzs_tpu/ops/pgather.py _gather_kernel (K10). A TPU lane gather
// reaches 128 entries, so the Pallas kernel walks the table's 128-lane
// chunks and selects by the index's high bits, which also ties W and Q to
// multiples of 128. A CUDA thread loads any address: here each output is
// one clamped load, for any W and Q.
//
// Bound: memory. Each query reads its index and writes its output (8
// bytes) and reads one table entry; the entries a row's queries share
// (the probe's spans overlap, its lanes' run columns repeat) come from
// cache, so the table costs only the entries touched.
//
// Design: a 2-D grid, the row from blockIdx.y (no divide per output) and
// ceil(Q / (4 * 128)) CTAs of 128 threads along each row (2 per row at the
// probe's 1024-query run column, so 512 CTAs at B = 256 fill the 132 SMs).
// Where Q % 4 == 0 and both rows are 16-byte aligned, each thread loads
// four indices with one int4 load, starts its four table loads together
// (read-only path) and stores four outputs with one int4 store; otherwise
// each thread handles one output with scalar accesses. Rows past the
// grid's 65535 limit are walked by a grid-stride loop over blockIdx.y.
#include "scan.cuh"

namespace {

constexpr int kGatherThreads = 128;
constexpr int kMaxGridY = 65535;

__device__ __forceinline__ int fetch(const int* row, int j, int w) {
  return __ldg(row + min(max(j, 0), w - 1));
}

template <bool kVec>
__global__ void __launch_bounds__(kGatherThreads)
gather_rows_kernel(const int* __restrict__ tab, const int* __restrict__ idx,
                   int* __restrict__ out, int rows, int w, int q) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= (kVec ? q / 4 : q)) return;
  for (int64_t row = blockIdx.y; row < rows; row += gridDim.y) {
    const int* trow = tab + row * w;
    if (kVec) {
      const int4 v = __ldg(reinterpret_cast<const int4*>(idx + row * q) + j);
      int4 o;
      o.x = fetch(trow, v.x, w);
      o.y = fetch(trow, v.y, w);
      o.z = fetch(trow, v.z, w);
      o.w = fetch(trow, v.w, w);
      reinterpret_cast<int4*>(out + row * q)[j] = o;
    } else {
      out[row * q + j] = fetch(trow, __ldg(idx + row * q + j), w);
    }
  }
}

}  // namespace

LZS_API int lzs_gather_rows(const int* tab, const int* idx, int* out,
                            int rows, int w, int q, int device,
                            void* stream) {
  const lzs::DeviceGuard guard(device);
  const bool vec = q % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(idx) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int per_row = vec ? q / 4 : q;
  const dim3 grid((per_row + kGatherThreads - 1) / kGatherThreads,
                  rows < kMaxGridY ? rows : kMaxGridY);
  const auto s = static_cast<cudaStream_t>(stream);
  if (vec) {
    gather_rows_kernel<true><<<grid, kGatherThreads, 0, s>>>(tab, idx, out,
                                                            rows, w, q);
  } else {
    gather_rows_kernel<false><<<grid, kGatherThreads, 0, s>>>(tab, idx, out,
                                                             rows, w, q);
  }
  return static_cast<int>(cudaGetLastError());
}
