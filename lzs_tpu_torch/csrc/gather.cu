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
// Design: one thread per output, a grid-stride loop over the flat (B, Q)
// plane (coalesced index loads and output stores; the table loads follow
// the indices).
#include "scan.cuh"

namespace {

constexpr int kGatherThreads = 256;

__global__ void __launch_bounds__(kGatherThreads)
gather_rows_kernel(const int* __restrict__ tab, const int* __restrict__ idx,
                   int* __restrict__ out, int64_t total, int w, int q) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       t < total; t += stride) {
    const int64_t row = t / q;
    const int j = min(max(idx[t], 0), w - 1);
    out[t] = tab[row * w + j];
  }
}

}  // namespace

LZS_API int lzs_gather_rows(const int* tab, const int* idx, int* out,
                            int rows, int w, int q, int device,
                            void* stream) {
  const lzs::DeviceGuard guard(device);
  const int64_t total = static_cast<int64_t>(rows) * q;
  const int64_t want = (total + kGatherThreads - 1) / kGatherThreads;
  const int blocks = static_cast<int>(want < (1 << 20) ? want : (1 << 20));
  gather_rows_kernel<<<blocks, kGatherThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(tab, idx, out,
                                                            total, w, q);
  return static_cast<int>(cudaGetLastError());
}
