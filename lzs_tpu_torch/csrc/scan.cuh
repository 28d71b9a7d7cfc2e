// Block-wide scans and the launch plumbing shared by the port's kernels.
//
// block_scan scans one value per thread across a CTA (warp shuffles, then
// one warp over the warp totals); cand.cu and sync.cu use it. The row
// scans are chained (chain.cuh). blockDim.x is a multiple of 32, at most
// 1024.
#pragma once

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace lzs {

constexpr int kThreads = 1024;

struct MaxOp {
  static constexpr int identity = INT_MIN;
  __device__ __forceinline__ int operator()(int a, int b) const {
    return a > b ? a : b;
  }
};

struct MinOp {
  static constexpr int identity = INT_MAX;
  __device__ __forceinline__ int operator()(int a, int b) const {
    return a < b ? a : b;
  }
};

// Wraps modulo 2^32, as int32 sums do in torch and in JAX.
struct AddOp {
  static constexpr int identity = 0;
  __device__ __forceinline__ int operator()(int a, int b) const {
    return static_cast<int>(static_cast<unsigned>(a) +
                            static_cast<unsigned>(b));
  }
};

// Inclusive scan of one value per thread in thread order. `warp_tot` is
// __shared__ int[32]. Returns the inclusive prefix; *excl receives the
// exclusive prefix (Op::identity for thread 0) and *total the CTA total.
// Every thread of the CTA must call it.
template <class Op>
__device__ __forceinline__ int block_scan(int v, Op op, int* warp_tot,
                                          int* excl, int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    int u = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v = op(v, u);
  }
  int wex = __shfl_up_sync(0xffffffffu, v, 1);
  if (lane == 0) wex = Op::identity;
  if (lane == 31) warp_tot[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int t = lane < nwarps ? warp_tot[lane] : Op::identity;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      int u = __shfl_up_sync(0xffffffffu, t, d);
      if (lane >= d) t = op(t, u);
    }
    warp_tot[lane] = t;  // inclusive over warps
  }
  __syncthreads();
  const int before = warp > 0 ? warp_tot[warp - 1] : Op::identity;
  *excl = op(before, wex);
  *total = warp_tot[nwarps - 1];
  __syncthreads();  // warp_tot is reused by the next call
  return op(before, v);
}

// Floor division and modulo (JAX's // and % on int32; C++ truncates).
__device__ __forceinline__ int floor_div(int a, int b) {
  int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

__device__ __forceinline__ int floor_mod(int a, int b) {
  int r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? r + b : r;
}

// Makes `device` current for the guard's lifetime and then restores the
// caller's current device.
class DeviceGuard {
 public:
  explicit DeviceGuard(int device) {
    cudaGetDevice(&prev_);
    if (prev_ != device) cudaSetDevice(device);
    set_ = prev_ != device;
  }
  ~DeviceGuard() {
    if (set_) cudaSetDevice(prev_);
  }
  DeviceGuard(const DeviceGuard&) = delete;
  DeviceGuard& operator=(const DeviceGuard&) = delete;

 private:
  int prev_ = 0;
  bool set_ = false;
};

}  // namespace lzs

// Launch plumbing: every C entry point selects the device it is given
// (restoring the caller's on return), launches on the stream it is given
// and returns cudaGetLastError().
#define LZS_API extern "C" __attribute__((visibility("default")))
