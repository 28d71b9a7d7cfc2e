// Greedy token walk: which positions of a row start a token, when a
// token at i is followed by one at i + max(step[i], 1) and the chain
// starts at 0. Three kernels, one per stage of the pointer-doubling
// decomposition, over rows of T tiles of 128 positions:
//
//   walk_tables   in-tile jump tables: level t holds the position after
//                 2^t hops, frozen once the chain leaves the tile; level
//                 7 is the tile's exit.
//   walk_entries  the entry of tile t + 1 is the exit of the chain from
//                 tile t's entry: the walk's one serial dependency.
//   walk_descent  each position descends the 7 levels from its tile's
//                 entry; it starts a token iff the chain lands on it.
//
// Replaces: lzs_tpu/ops/pwalk.py _tables_kernel (K11), _entries_kernel
// (K12) and _descent_kernel (K13). The TPU kernels batch rows per
// program and gather over the 128 lanes of a vector register; here a
// tile is a group of 128 threads and its table lives in shared memory.
//
// Bound: walk_tables and walk_descent are memory-bound (tables: 4 bytes
// read and 32 written per position; descent: 28 read and 1 written); the
// doubling rounds are shared-memory reads between barriers. walk_entries
// needs only one exit per tile the chain enters, but which one depends on
// the tile before: a thread that loads it from device memory waits a full
// round trip per tile. Here the row's exits stream into shared memory
// ahead of the walk instead: one CTA per row, whose first warp keeps a
// ring of kRing chunks of kChunk tiles in flight (cp.async, 16 bytes per
// copy where the table is 16-byte aligned, else 4, each lane's copies
// signalling the chunk's "full" mbarrier as they land), while one thread
// of the second warp follows the chain through each chunk in shared
// memory and releases the chunk's slot through its "empty" mbarrier. The
// walk costs one shared-memory load per tile it enters, the stream reads
// the whole table once (the floor of this form: every exit, not only the
// entered ones).
//
// All positions are int32 (chains reach N + the largest step).
#include "async.cuh"
#include "scan.cuh"

namespace {

constexpr int kTile = 128;
constexpr int kLevels = 7;            // log2(kTile)
constexpr int kTilesPerCta = 4;
constexpr int kWalkThreads = kTile * kTilesPerCta;
constexpr int kChunk = 16;            // tiles per ring slot (8 KiB)
constexpr int kRing = 8;              // slots in flight (64 KiB)
constexpr int kEntryThreads = 64;     // a copy warp and a walking warp
constexpr size_t kRingBytes = sizeof(int) * kRing * kChunk * kTile;

// step, exits: int32[R * 128] for R = B * T tiles (row-major (B, T, 128));
// tabs: int32[7, R * 128].
__global__ void __launch_bounds__(kWalkThreads)
walk_tables_kernel(const int* __restrict__ step, int* __restrict__ tabs,
                   int* __restrict__ exits, int64_t ntiles, int T) {
  __shared__ int tab[kTilesPerCta][kTile];
  const int g = threadIdx.x / kTile;
  const int lane = threadIdx.x % kTile;
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kTilesPerCta + g;
  const bool live = r < ntiles;
  const int64_t at = r * kTile + lane;
  const int base = live ? static_cast<int>(r % T) * kTile : 0;
  int a = live ? base + lane + max(step[at], 1) : 0;
  for (int t = 0; t < kLevels; ++t) {
    if (live) tabs[t * ntiles * kTile + at] = a;
    tab[g][lane] = a;
    __syncthreads();
    const int gat = tab[g][min(max(a - base, 0), kTile - 1)];
    __syncthreads();
    if (a < base + kTile) a = gat;
  }
  if (live) exits[at] = a;
}

using lzs::mbar_arrive;
using lzs::mbar_arrive_copies;
using lzs::mbar_init;
using lzs::mbar_wait;

template <int kBytes>
__device__ __forceinline__ void cp_async(int* smem, const int* gmem) {
  if (kBytes == 16) {
    lzs::cp_async16(smem, gmem);
  } else {
    lzs::cp_async4(smem, gmem);
  }
}

// exits: int32[B, T, 128]; entries: int32[B, T]. One CTA per row: warp 0
// copies chunk k of the row's exits into ring slot k % kRing once the walk
// has released that slot's previous chunk; thread 32 walks.
template <int kCopyBytes>
__global__ void __launch_bounds__(kEntryThreads)
walk_entries_kernel(const int* __restrict__ exits, int* __restrict__ entries,
                    int T) {
  extern __shared__ __align__(16) int ring[];
  __shared__ uint64_t full[kRing], empty[kRing];
  const int64_t row = blockIdx.x;
  const int* ex = exits + row * T * kTile;
  const int nchunks = (T + kChunk - 1) / kChunk;
  if (threadIdx.x < kRing) {
    mbar_init(&full[threadIdx.x], 32);   // one arrival per copying lane
    mbar_init(&empty[threadIdx.x], 1);   // the walker's release
  }
  __syncthreads();

  if (threadIdx.x < 32) {
    constexpr int kStep = kCopyBytes / 4;            // ints per copy
    for (int k = 0; k < nchunks; ++k) {
      const int slot = k % kRing;
      if (k >= kRing) mbar_wait(&empty[slot], (k / kRing - 1) & 1);
      const int t0 = k * kChunk;
      const int len = min(kChunk, T - t0) * kTile;
      const int* src = ex + static_cast<int64_t>(t0) * kTile;
      int* dst = ring + slot * kChunk * kTile;
      for (int i = threadIdx.x * kStep; i < len; i += 32 * kStep)
        cp_async<kCopyBytes>(dst + i, src + i);
      mbar_arrive_copies(&full[slot]);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  } else if (threadIdx.x == 32) {
    int* ent = entries + row * T;
    int c = 0;
    for (int k = 0; k < nchunks; ++k) {
      const int slot = k % kRing;
      const int t0 = k * kChunk;
      const int t1 = min(T, t0 + kChunk);
      mbar_wait(&full[slot], (k / kRing) & 1);
      // ring[p + shift] is the exit of position p of this chunk's tiles
      const int shift = (slot * kChunk - t0) * kTile;
      for (int t = t0; t < t1; ++t) {
        ent[t] = c;
        // c in tile t, as one unsigned compare (a c < 0 wraps above it)
        if (static_cast<unsigned>(c) - static_cast<unsigned>(t * kTile) <
            static_cast<unsigned>(kTile))
          c = ring[c + shift];
      }
      mbar_arrive(&empty[slot]);
    }
  }
}

template <int kCopyBytes>
cudaError_t launch_entries(const int* exits, int* entries, int B, int T,
                           cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      walk_entries_kernel<kCopyBytes>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kRingBytes));
  if (err != cudaSuccess) return err;
  walk_entries_kernel<kCopyBytes><<<B, kEntryThreads, kRingBytes, stream>>>(
      exits, entries, T);
  return cudaGetLastError();
}

// tabs: int32[7, B * T * 128]; entries: int32[B * T]; n: int32[B];
// starts: uint8[B, width] (width <= T * 128), 1 at token starts < n[b].
__global__ void __launch_bounds__(kWalkThreads)
walk_descent_kernel(const int* __restrict__ tabs,
                    const int* __restrict__ entries,
                    const int* __restrict__ n, uint8_t* __restrict__ starts,
                    int64_t ntiles, int T, int width) {
  __shared__ int tab[kTilesPerCta][kLevels][kTile];
  const int g = threadIdx.x / kTile;
  const int lane = threadIdx.x % kTile;
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kTilesPerCta + g;
  const bool live = r < ntiles;
  const int64_t at = r * kTile + lane;
  if (live) {
#pragma unroll
    for (int t = 0; t < kLevels; ++t) {
      tab[g][t][lane] = tabs[t * ntiles * kTile + at];
    }
  }
  __syncthreads();
  if (!live) return;
  const int64_t b = r / T;
  const int base = static_cast<int>(r % T) * kTile;
  const int i = base + lane;
  int pos = entries[r];
#pragma unroll
  for (int t = kLevels - 1; t >= 0; --t) {
    const int nxt = tab[g][t][min(max(pos - base, 0), kTile - 1)];
    if (pos >= base && pos < base + kTile && nxt <= i) pos = nxt;
  }
  if (i < width) starts[b * width + i] = (pos == i && i < n[b]) ? 1 : 0;
}

unsigned walk_blocks(int64_t ntiles) {
  return static_cast<unsigned>((ntiles + kTilesPerCta - 1) / kTilesPerCta);
}

}  // namespace

LZS_API int lzs_walk_tables(const int* step, int* tabs, int* exits, int B,
                            int T, int device, void* stream) {
  const lzs::DeviceGuard guard(device);
  const int64_t ntiles = static_cast<int64_t>(B) * T;
  walk_tables_kernel<<<walk_blocks(ntiles), kWalkThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      step, tabs, exits, ntiles, T);
  return static_cast<int>(cudaGetLastError());
}

LZS_API int lzs_walk_entries(const int* exits, int* entries, int B, int T,
                             int device, void* stream) {
  const lzs::DeviceGuard guard(device);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // a row is T * 512 bytes, so every row is aligned where the table is
  const bool vec = (reinterpret_cast<uintptr_t>(exits) & 15) == 0;
  return static_cast<int>(vec ? launch_entries<16>(exits, entries, B, T, s)
                              : launch_entries<4>(exits, entries, B, T, s));
}

LZS_API int lzs_walk_descent(const int* tabs, const int* entries,
                             const int* n, uint8_t* starts, int B, int T,
                             int width, int device, void* stream) {
  const lzs::DeviceGuard guard(device);
  const int64_t ntiles = static_cast<int64_t>(B) * T;
  walk_descent_kernel<<<walk_blocks(ntiles), kWalkThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      tabs, entries, n, starts, ntiles, T, width);
  return static_cast<int>(cudaGetLastError());
}
