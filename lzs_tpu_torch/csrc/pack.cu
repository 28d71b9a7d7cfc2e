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
// Design: a row is split over a thread-block cluster of up to 8 CTAs of
// 256 threads, one segment of 256 * kRun units each (kRun 16, or 32 for
// rows past 32768 units: 65536 units make 8 segments of 8192), so a row
// is never walked tile after tile (the form this replaces scanned a row's
// 1024-unit tiles in turn, three barriers and its stores each, in one CTA,
// PERF.md). Each CTA
//   1. loads its whole segment at once, width and value in groups of 4
//      (one 16-byte load each, warp-striped as in chain.cuh: group g of
//      lane l of warp w holds the units at w * 32 * kRun + g * 128 + l * 4),
//      and scans the widths once (in the thread, across the warp by
//      shuffles, across the warps in shared memory);
//   2. reads the cluster's segment totals through distributed shared
//      memory, which gives its own first bit P_c and the row's total, and
//      stores every unit's exclusive bit offset (16 bytes a group);
//   3. ORs each live unit's 64-bit big-endian window into a slab of words
//      in shared memory that covers its own bit range [P_c, Q_c) (Q_c =
//      P_(c+1); the last CTA's range ends past the end marker, which it
//      ORs in as one more unit), with shared-memory atomics (units never
//      share bits, so OR is the reference's bit-queue append,
//      lzs-compression.c:303-313);
//   4. after a cluster barrier, writes the words whose first bit lies in
//      its range, in coalesced big-endian stores. Only the last of them
//      can hold bits of later segments (a segment whose units all have
//      width 0 owns no word, so one word can span three segments or
//      more): it ORs in word 0 of each later slab that starts inside it,
//      through distributed shared memory. The words from the stream's end
//      to cap_bytes / 4 are zeroed, split over the cluster.
// One launch, no global atomics, no memset. Windows and words past
// cap_bytes / 4 are dropped, as the plain version drops them.
#include <cooperative_groups.h>

#include "chain.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kPackThreads = 256;
constexpr int kPackWarps = kPackThreads / 32;
constexpr int kMaxCluster = 8;

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

// ORs a window into the slab whose word 0 is stream word `first`
// (widths 0..32: a unit's words lie in its CTA's range, so in the slab).
template <int kSlab>
__device__ __forceinline__ void or_window(unsigned* slab, int first,
                                          unsigned v, int start, int width) {
  int w0;
  unsigned hi, lo;
  window(v, start, width, &w0, &hi, &lo);
  const unsigned k = static_cast<unsigned>(w0 - first);
  if (hi && k < kSlab) atomicOr(slab + k, hi);
  if (lo && k + 1 < kSlab) atomicOr(slab + k + 1, lo);
}

template <bool kVec, int kRun>
__global__ void __launch_bounds__(kPackThreads)
pack_kernel(const int* __restrict__ value, const int* __restrict__ width,
            int m, uint8_t* __restrict__ comp, int cap_bytes,
            int* __restrict__ total_bits, int* __restrict__ offs,
            unsigned end_value, int end_bits) {
  constexpr int kSeg = kPackThreads * kRun;
  // a segment's bits at 32 per unit, the end marker and the words that
  // its range's ends cut: whole words
  constexpr int kSlab = kSeg + 8;
  __shared__ __align__(16) unsigned slab[kSlab];
  __shared__ int warp_tot[kPackWarps];
  __shared__ int seg_bits;                 // read by the cluster
  __shared__ int starts[kMaxCluster + 1];  // P_0 .. P_(ncta-1), Q_last
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int ncta = static_cast<int>(cluster.num_blocks());
  const int64_t row = blockIdx.x / ncta;
  const int lo = rank * kSeg;
  const int lim = min(m - lo, kSeg);
  const int64_t base = row * m + lo;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  for (int k = threadIdx.x; k < kSlab / 4; k += kPackThreads)
    reinterpret_cast<int4*>(slab)[k] = make_int4(0, 0, 0, 0);

  int w[kRun], o[kRun];
  unsigned v[kRun];
#pragma unroll
  for (int r = 0; r < kRun; r += 4) {
    const int e = lzs::striped<kRun>(r);
    if (kVec && e < lim) {   // lim % 4 == 0
      const int4 w4 = __ldg(reinterpret_cast<const int4*>(width + base + e));
      const int4 v4 = __ldg(reinterpret_cast<const int4*>(value + base + e));
      w[r] = w4.x;
      w[r + 1] = w4.y;
      w[r + 2] = w4.z;
      w[r + 3] = w4.w;
      v[r] = v4.x;
      v[r + 1] = v4.y;
      v[r + 2] = v4.z;
      v[r + 3] = v4.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool in = !kVec && e + j < lim;
        w[r + j] = in ? __ldg(width + base + e + j) : 0;
        v[r + j] = in ? __ldg(value + base + e + j) : 0u;
      }
    }
  }
  // exclusive offsets within the warp's part, group by group
  int warp_part = 0;
#pragma unroll
  for (int r = 0; r < kRun; r += 4) {
    o[r] = 0;
    o[r + 1] = w[r];
    o[r + 2] = w[r] + w[r + 1];
    o[r + 3] = o[r + 2] + w[r + 2];
    int x = o[r + 3] + w[r + 3];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int u = __shfl_up_sync(lzs::kFull, x, d);
      if (lane >= d) x += u;
    }
    int before = __shfl_up_sync(lzs::kFull, x, 1);
    if (lane == 0) before = 0;
    before += warp_part;
    warp_part += __shfl_sync(lzs::kFull, x, 31);
#pragma unroll
    for (int j = 0; j < 4; ++j) o[r + j] += before;
  }
  if (lane == 0) warp_tot[warp] = warp_part;
  __syncthreads();
  int warp_before = 0, seg = 0;
#pragma unroll
  for (int k = 0; k < kPackWarps; ++k) {
    const int t = warp_tot[k];
    if (k < warp) warp_before += t;
    seg += t;
  }
  if (threadIdx.x == 0) seg_bits = seg;
  cluster.sync();   // every segment's total, and the slab zeroed

  // lane r reads segment r's total: this CTA's first bit and the row's
  const int t = lane < ncta ? *cluster.map_shared_rank(&seg_bits, lane) : 0;
  int first = lane < rank ? t : 0;
  int total = t;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    first += __shfl_xor_sync(lzs::kFull, first, d);
    total += __shfl_xor_sync(lzs::kFull, total, d);
  }
  const int tb = total + end_bits;
  if (warp == 0) {
    // P_lane for lane < ncta (an exclusive sum), the stream's end last
    int p = t;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int u = __shfl_up_sync(lzs::kFull, p, d);
      if (lane >= d) p += u;
    }
    if (lane < ncta) starts[lane] = p - t;
    if (lane == 0) starts[ncta] = tb;
  }
  const int wfirst = first >> 5;   // the slab's word 0
  const int add = first + warp_before;
#pragma unroll
  for (int r = 0; r < kRun; r += 4) {
    const int e = lzs::striped<kRun>(r);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      o[r + j] += add;
      if (w[r + j] > 0)
        or_window<kSlab>(slab, wfirst, v[r + j], o[r + j], w[r + j]);
    }
    if (kVec && e < lim) {
      *reinterpret_cast<int4*>(offs + base + e) =
          make_int4(o[r], o[r + 1], o[r + 2], o[r + 3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (!kVec && e + j < lim) offs[base + e + j] = o[r + j];
    }
  }
  if (rank == ncta - 1 && threadIdx.x == 0 && end_bits > 0)
    or_window<kSlab>(slab, wfirst, end_value, total, end_bits);
  cluster.sync();   // every slab whole; starts[] written

  // the words whose first bit lies in [P_c, Q_c)
  const int cap_words = cap_bytes >> 2;
  const int q = starts[rank + 1];
  uint32_t* out = reinterpret_cast<uint32_t*>(comp + row * cap_bytes);
  const int k0 = (first + 31) >> 5;
  const int k1 = q > first ? (q + 31) >> 5 : k0;
  for (int k = k0 + threadIdx.x; k < min(k1, cap_words);
       k += kPackThreads) {
    unsigned x = slab[k - wfirst];
    if (k == k1 - 1) {
      // later segments that start inside this word: their slab's word 0
      for (int c = rank + 1; c < ncta && starts[c] < 32 * k + 32; ++c)
        if (starts[c + 1] > starts[c])
          x |= *cluster.map_shared_rank(slab, c);
    }
    out[k] = __byte_perm(x, 0u, 0x0123);   // big-endian byte order
  }
  // no more reads of other slabs: arrive now, wait before exit
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  for (int k = ((tb + 31) >> 5) + rank * kPackThreads + threadIdx.x;
       k < cap_words; k += ncta * kPackThreads)
    out[k] = 0u;
  if (rank == 0 && threadIdx.x == 0) total_bits[row] = tb;
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

template <bool kVec, int kRun>
cudaError_t launch_pack(const int* value, const int* width, int rows, int m,
                        uint8_t* comp, int cap_bytes, int* total_bits,
                        int* offs, unsigned end_value, int end_bits,
                        cudaStream_t stream) {
  constexpr int kSeg = kPackThreads * kRun;
  const int ncta = (m + kSeg - 1) / kSeg;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(rows) * ncta);
  config.blockDim = dim3(kPackThreads);
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ncta;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  return cudaLaunchKernelEx(&config, pack_kernel<kVec, kRun>, value, width,
                            m, comp, cap_bytes, total_bits, offs, end_value,
                            end_bits);
}

// 16 units a thread where the row fits 8 such segments (32768 units),
// else 32
template <bool kVec>
cudaError_t pack_rows(const int* value, const int* width, int rows, int m,
                      uint8_t* comp, int cap_bytes, int* total_bits,
                      int* offs, unsigned end_value, int end_bits,
                      cudaStream_t stream) {
  if (m > kMaxCluster * kPackThreads * 16)
    return launch_pack<kVec, 32>(value, width, rows, m, comp, cap_bytes,
                                 total_bits, offs, end_value, end_bits,
                                 stream);
  return launch_pack<kVec, 16>(value, width, rows, m, comp, cap_bytes,
                               total_bits, offs, end_value, end_bits, stream);
}

}  // namespace

// m: 1 .. 65536 units a row (8 segments of 8192); cap_bytes % 4 == 0.
LZS_API int lzs_pack_rows(const int* value, const int* width, int rows, int m,
                          uint8_t* comp, int cap_bytes, int* total_bits,
                          int* offs, int end_value, int end_bits, int use_end,
                          int device, void* stream) {
  const lzs::DeviceGuard guard(device);
  if (m < 1 || m > kMaxCluster * kPackThreads * 32 || cap_bytes % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = m % 4 == 0 && lzs::aligned16(value) &&
                   lzs::aligned16(width) && lzs::aligned16(offs);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned ev = static_cast<unsigned>(end_value);
  const int eb = use_end ? end_bits : 0;
  const cudaError_t err =
      vec ? pack_rows<true>(value, width, rows, m, comp, cap_bytes,
                            total_bits, offs, ev, eb, s)
          : pack_rows<false>(value, width, rows, m, comp, cap_bytes,
                             total_bits, offs, ev, eb, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
