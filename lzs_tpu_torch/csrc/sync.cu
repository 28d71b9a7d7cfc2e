// Decode-sync records: the parser state at the last parse step before
// every multiple of `span` compressed bits, stored straight into its slot.
//
// Replaces: lzs_tpu/ops/psync.py _sync_kernel (K16: owner cummax,
// parse-step predicate, next-step reverse cummin, span-crossing keys) and
// the three compaction sorts after it in lzs_tpu/ops/encode.py
// _sync_records_batch. A parse step is at most 24 bits < span, so each
// boundary span*c has exactly one crossing step: slot c is a store.
//
// Bound: bytes. Per position one byte of `starts` and three int32 rows
// are read once (13 bytes); the output is two slot rows of a few hundred
// entries. The work per position is a handful of integer operations.
//
// Design: a row is split over a thread-block cluster of up to four CTAs
// of 512 threads, 8192 positions each, one wave-free launch of
// rows x ceil(npos / 8192) small CTAs. Each thread owns a run of 16
// consecutive positions, loaded with 16-byte vector loads (scalar loads
// where the row is not 16-aligned), and keeps them in registers:
//   1. the owner-token cummax (start << 12 | clipped offset) runs along
//      the run; one block scan of the thread totals and the totals of the
//      earlier CTAs of the cluster, read through distributed shared
//      memory, give every position its owner;
//   2. each position decides whether it is a parse step (a token head, or
//      every `nibbles`-th extension nibble); the suffix min of step
//      offsets, seeded with end_bits (the bit after the last step), runs
//      backwards along the run after one reverse block scan and the
//      totals of the later CTAs: it is the next step's offset, and a step
//      whose successor lies past a span boundary c < nsync stores its
//      record in slot c.
// Slot 0 is the stream start, slots >= nsync the sentinel (end_bits, n);
// every slot is first set to those values, and the crossing stores come
// after two cluster barriers, which order them after the fill. JAX's //
// and % floor; floor_div / floor_mod mirror them. The record keeps the
// TPU kernel's 0xFFF offset clip and 29 record bits.
#include <cooperative_groups.h>

#include "scan.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kBig = 0x3FFFFFFF;
constexpr int kRecMask = 0x1FFFFFFF;
constexpr int kSyncThreads = 512;
constexpr int kRun = 16;                       // positions per thread
constexpr int kSegment = kSyncThreads * kRun;  // positions per CTA
constexpr int kMaxCluster = 4;                 // 4 x 8192 = 32768

// Inclusive suffix scan (min) of one value per thread, from the last
// thread back to the first: *excl receives the min over later threads
// (MinOp::identity for the last) and *total the CTA's min.
__device__ __forceinline__ void block_suffix_min(int v, int* warp_tot,
                                                 int* excl, int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_down_sync(0xffffffffu, v, d);
    if (lane + d < 32) v = min(v, u);
  }
  int wex = __shfl_down_sync(0xffffffffu, v, 1);
  if (lane == 31) wex = lzs::MinOp::identity;
  if (lane == 0) warp_tot[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int t = lane < nwarps ? warp_tot[lane] : lzs::MinOp::identity;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int u = __shfl_down_sync(0xffffffffu, t, d);
      if (lane + d < 32) t = min(t, u);
    }
    warp_tot[lane] = t;  // min over warps >= lane
  }
  __syncthreads();
  const int after =
      warp + 1 < nwarps ? warp_tot[warp + 1] : lzs::MinOp::identity;
  *excl = min(after, wex);
  *total = warp_tot[0];
  __syncthreads();  // warp_tot is reused by the next call
}

// One thread's run: starts, width == 4 and the three int32 rows at
// positions p0 .. p0 + kRun - 1 (positions >= npos read as no token).
template <bool kVec>
__device__ __forceinline__ void load_run(const uint8_t* st, const int* wd,
                                         const int* of, const int* os,
                                         int p0, int npos, unsigned* head,
                                         unsigned* four, int (&off)[kRun],
                                         int (&offs)[kRun]) {
  unsigned h = 0, f = 0;
  if (kVec) {
    if (p0 < npos) {   // npos % 16 == 0: the run is wholly inside
      const uint4 sv = *reinterpret_cast<const uint4*>(st + p0);
      const unsigned sw[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
      for (int q = 0; q < kRun; ++q)
        h |= ((sw[q >> 2] >> (8 * (q & 3))) & 0xFFu ? 1u : 0u) << q;
#pragma unroll
      for (int v = 0; v < kRun / 4; ++v) {
        const int4 w = *reinterpret_cast<const int4*>(wd + p0 + 4 * v);
        const int4 a = *reinterpret_cast<const int4*>(of + p0 + 4 * v);
        const int4 b = *reinterpret_cast<const int4*>(os + p0 + 4 * v);
        f |= ((w.x == 4 ? 1u : 0u) | (w.y == 4 ? 2u : 0u) |
              (w.z == 4 ? 4u : 0u) | (w.w == 4 ? 8u : 0u)) << (4 * v);
        off[4 * v] = a.x; off[4 * v + 1] = a.y;
        off[4 * v + 2] = a.z; off[4 * v + 3] = a.w;
        offs[4 * v] = b.x; offs[4 * v + 1] = b.y;
        offs[4 * v + 2] = b.z; offs[4 * v + 3] = b.w;
      }
    } else {
#pragma unroll
      for (int q = 0; q < kRun; ++q) off[q] = offs[q] = 0;
    }
  } else {
#pragma unroll
    for (int q = 0; q < kRun; ++q) {
      const int p = p0 + q;
      const bool in = p < npos;
      h |= (in && st[p] != 0 ? 1u : 0u) << q;
      f |= (in && wd[p] == 4 ? 1u : 0u) << q;
      off[q] = in ? of[p] : 0;
      offs[q] = in ? os[p] : 0;
    }
  }
  *head = h;
  *four = f;
}

template <bool kVec>
__global__ void __launch_bounds__(kSyncThreads, 2)
sync_kernel(const uint8_t* __restrict__ starts, const int* __restrict__ width,
            const int* __restrict__ off, const int* __restrict__ offs,
            const int* __restrict__ end_bits, const int* __restrict__ n,
            int npos, int span, int nibbles, int short_len, int ext_len,
            int nslots, int* __restrict__ sync_bit,
            int* __restrict__ sync_out, int* __restrict__ nsync) {
  __shared__ int warp_tot[32];
  __shared__ int cta_max;   // this CTA's owner-key max, read by later CTAs
  __shared__ int cta_min;   // its step-offset min, read by earlier CTAs
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int ncta = static_cast<int>(cluster.num_blocks());
  const int64_t row = blockIdx.x / ncta;
  const int eb = end_bits[row];
  const int ns = lzs::floor_div(eb + span - 1, span);
  int* sb = sync_bit + row * nslots;
  int* so = sync_out + row * nslots;

  for (int s = rank * kSyncThreads + threadIdx.x; s < nslots;
       s += ncta * kSyncThreads) {
    const bool live = s < ns;
    sb[s] = live ? 0 : eb;
    so[s] = live ? 0 : n[row];
  }

  const int p0 = rank * kSegment + threadIdx.x * kRun;
  unsigned head, four;
  int key[kRun], o[kRun];
  load_run<kVec>(starts + row * npos, width + row * npos, off + row * npos,
                 offs + row * npos, p0, npos, &head, &four, key, o);

  // 1. owner-token cummax along the run, then across threads and CTAs
  int run = lzs::MaxOp::identity;
#pragma unroll
  for (int q = 0; q < kRun; ++q) {
    const int v = (head >> q) & 1 ? (((p0 + q) << 12) | min(key[q], 0xFFF))
                                  : -1;
    run = max(run, v);
    key[q] = run;
  }
  int excl, total;
  lzs::block_scan(run, lzs::MaxOp{}, warp_tot, &excl, &total);
  if (threadIdx.x == 0) cta_max = total;
  cluster.sync();
  int carry = lzs::MaxOp::identity;
  for (int r = 0; r < rank; ++r)
    carry = max(carry, *cluster.map_shared_rank(&cta_max, r));
  carry = max(carry, excl);

  // 2. parse steps; the next step's offset by a suffix min of the step
  // offsets (kBig at other positions), seeded with end_bits past the row.
  // m = t mod nibbles (t = i - owner - 1) is counted along the run while
  // the owner stays; a new owner is as a rule the head at i itself (t =
  // -1), so a division is left only for the first position.
  unsigned step = 0;
  int low = lzs::MinOp::identity;
  int m = 0;
#pragma unroll
  for (int q = 0; q < kRun; ++q) {
    key[q] = max(carry, key[q]);
    if (q == 0 || key[q] != key[q - 1]) {
      const int t = p0 + q - (key[q] >> 12) - 1;
      m = t == -1 ? nibbles - 1 : lzs::floor_mod(t, nibbles);
    } else {
      m = m + 1 == nibbles ? 0 : m + 1;
    }
    const bool h = (head >> q) & 1;
    const bool is_step = h || (((four >> q) & 1) && m == 0);
    step |= (is_step ? 1u : 0u) << q;
    o[q] = is_step ? o[q] : kBig;
    if (p0 + q < npos) low = min(low, o[q]);
  }
  block_suffix_min(low, warp_tot, &excl, &total);
  if (threadIdx.x == 0) cta_min = total;
  cluster.sync();
  int nxt = eb;
  for (int r = rank + 1; r < ncta; ++r)
    nxt = min(nxt, *cluster.map_shared_rank(&cta_min, r));
  // the earlier CTAs may still read this CTA's totals: arrive now, wait
  // before exit
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  nxt = min(nxt, excl);
  // floor division by the span: a shift where it is a power of two
  const int shift = (span & (span - 1)) == 0 ? __ffs(span) - 1 : -1;
  const auto slot_of = [=](int x) {
    return shift >= 0 ? x >> shift : lzs::floor_div(x, span);
  };
#pragma unroll
  for (int q = kRun - 1; q >= 0; --q) {
    if ((step >> q) & 1) {
      const int c = slot_of(nxt);
      if (slot_of(o[q]) < c && c < ns) {
        const int i = p0 + q;
        const int owner_i = key[q] >> 12;
        const int owner_off = key[q] & 0xFFF;
        const int opos = owner_i + short_len + ext_len * (i - owner_i - 1);
        const int rec =
            (head >> q) & 1 ? i : (opos | (1 << 17) | (owner_off << 18));
        sb[c] = o[q];
        so[c] = rec & kRecMask;
      }
    }
    if (p0 + q < npos) nxt = min(nxt, o[q]);
  }
  if (rank == 0 && threadIdx.x == 0) nsync[row] = ns;
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

template <bool kVec>
cudaError_t launch_sync(const uint8_t* starts, const int* width,
                        const int* off, const int* offs, const int* end_bits,
                        const int* n, int rows, int npos, int span,
                        int nibbles, int short_len, int ext_len, int nslots,
                        int* sync_bit, int* sync_out, int* nsync,
                        cudaStream_t stream) {
  const int ncta = npos > 0 ? (npos + kSegment - 1) / kSegment : 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(rows) * ncta);
  config.blockDim = dim3(kSyncThreads);
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ncta;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  return cudaLaunchKernelEx(&config, sync_kernel<kVec>, starts, width, off,
                            offs, end_bits, n, npos, span, nibbles,
                            short_len, ext_len, nslots, sync_bit, sync_out,
                            nsync);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

LZS_API int lzs_sync_rows(const uint8_t* starts, const int* width,
                          const int* off, const int* offs, const int* end_bits,
                          const int* n, int rows, int npos, int span,
                          int nibbles, int short_len, int ext_len, int nslots,
                          int* sync_bit, int* sync_out, int* nsync,
                          int device, void* stream) {
  const lzs::DeviceGuard guard(device);
  if (npos > kMaxCluster * kSegment) return cudaErrorInvalidValue;
  const bool vec = npos % 16 == 0 && aligned16(starts) && aligned16(width) &&
                   aligned16(off) && aligned16(offs);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      vec ? launch_sync<true>(starts, width, off, offs, end_bits, n, rows,
                              npos, span, nibbles, short_len, ext_len, nslots,
                              sync_bit, sync_out, nsync, s)
          : launch_sync<false>(starts, width, off, offs, end_bits, n, rows,
                               npos, span, nibbles, short_len, ext_len,
                               nslots, sync_bit, sync_out, nsync, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
