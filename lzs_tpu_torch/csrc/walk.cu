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
// is latency-bound: one thread per row follows the chain through T
// tiles, one dependent load per tile the chain enters. It is the simple
// correct form, not a fast one.
//
// All positions are int32 (chains reach N + the largest step).
#include "scan.cuh"

namespace {

constexpr int kTile = 128;
constexpr int kLevels = 7;            // log2(kTile)
constexpr int kTilesPerCta = 4;
constexpr int kWalkThreads = kTile * kTilesPerCta;
constexpr int kEntryThreads = 32;

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

// exits: int32[B, T, 128]; entries: int32[B, T]. One thread per row.
__global__ void __launch_bounds__(kEntryThreads)
walk_entries_kernel(const int* __restrict__ exits, int* __restrict__ entries,
                    int B, int T) {
  const int b = blockIdx.x * kEntryThreads + threadIdx.x;
  if (b >= B) return;
  const int* ex = exits + static_cast<int64_t>(b) * T * kTile;
  int* ent = entries + static_cast<int64_t>(b) * T;
  int c = 0;
  for (int t = 0; t < T; ++t) {
    ent[t] = c;
    const int b0 = t * kTile;
    if (c >= b0 && c < b0 + kTile) {
      c = ex[static_cast<int64_t>(t) * kTile + c - b0];
    }
  }
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
  walk_entries_kernel<<<(B + kEntryThreads - 1) / kEntryThreads,
                        kEntryThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      exits, entries, B, T);
  return static_cast<int>(cudaGetLastError());
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
