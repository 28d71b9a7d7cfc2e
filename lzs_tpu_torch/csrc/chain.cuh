// The one-pass chained row scan (decoupled look-back) shared by K4 and
// K5 (extend.cu) and K6-K9 (rowscan.cu); its look-back and its epoch
// (below) also chain the raw decoder's heads stage across tiles
// (heads.cu).
//
// chain_scan_kernel<Op, kReverse, kVec, kRun, Io> scans int32 rows of n
// elements: one CTA of 256 threads per tile of 256 * kRun elements, the
// tiles' partial results chained through status words in one launch. An
// Io policy (passed by value) turns the row's inputs into the scanned
// values and the scan back into the row's output, one group of 4
// consecutive elements at a time:
//
//   io.load(at, i, vec, count, pad, v, kept, slot, stride)
//       fill v[0..3] with the values of elements at .. at + 3 of the
//       flattened rows (row column i .. i + 3); only `count` (0-4) of them
//       lie in the row, the rest take `pad` (Op's identity); `vec` says
//       that all 4 lie in the row and that 16-byte accesses are aligned.
//       `kept` (an Io::Kept) keeps what the store needs of the load.
//   io.store(at, i, vec, count, s, kept, slot, stride)
//       write the group's output from its inclusive scan s[0..3], or,
//       where Io::kExclusive, its exclusive scan: each element's value
//       before it in walk order (the walk's first element gets Op's
//       identity). The template forms it in place: a group's inclusive
//       values move one element against the walk, and the group's last
//       element in walk order takes the value before the group.
//   io.bind(row)
//       the policy as the CTA of row `row` uses it (K4 reads the row's
//       block length there; the others return themselves).
//   Io::kPlanes, io.stage(at, i, slot, stride)
//       a policy that reads several inputs stages them: for every `vec`
//       group the kernel first calls stage(), which copies the group's 16
//       bytes of each of kPlanes inputs into shared memory (cp.async, to
//       slot, slot + stride, ...), and waits for all the copies once, so
//       that every input's bytes are in flight together and no load
//       waits on another; load() and store() read the slots. (K5 read
//       ext_h only at heads, after `packed` said where they were: two
//       memory latencies in a row, slower than the whole plane, PERF.md.)
//       K6 stages a group's 4 mask bytes (a 4-byte copy into the slot).
//
//   * A CTA of 256 threads loads its tile with 16-byte loads,
//     warp-striped: register group g of lane l of warp w holds the 4
//     elements at w * 32 * kRun + g * 128 + l * 4, so each load of a warp
//     reads 512 consecutive bytes. (Runs of consecutive elements per
//     thread put the lanes 64 bytes apart, so that each load touches
//     twice the sectors it uses: slower, PERF.md.) Scalar loads serve a
//     row that is not 16-byte aligned and the row's ragged end. Each group
//     is scanned in the thread and across the warp with shuffles; the 8
//     warp totals, from shared memory, give the tile's total and each
//     warp's offset.
//   * The walk order: a forward scan walks a row's tiles from its start,
//     the suffix scan (kReverse) from its end; tiles are cut from the
//     row's start either way, so both align alike. Inside a tile the
//     suffix scan runs downwards at every level: a group's registers from
//     the highest, the lanes with shuffles down, the groups and the warps
//     from the highest.
//   * CTAs take tiles in walk order (blockIdx.x % tiles is the walk step),
//     and a tile waits only on the steps before its own, which run on
//     lower blockIdx: CTAs already resident or done, so the grid cannot
//     deadlock however many tiles it has.
//   * The tile publishes its total in its status word ("aggregate"); warp
//     0 then reads the words of the 32 steps before it at once, combines
//     aggregates back to the nearest inclusive prefix (or on through the
//     next 32), and publishes its own inclusive prefix. A word is
//     ((tag << 2 | flag) << 32 | value), flag 1 for an aggregate and 2 for
//     a prefix, and holds any int32 value.
//   * The words are never cleared between launches: a launch's tag is 1 +
//     the epoch in the buffer's first word, and a word of another tag (an
//     earlier launch's, or 0) reads as not yet written. Each CTA counts
//     itself done on that first word once its look-back is over (an
//     atomic whose result it reads only after its stores), and the last
//     CTA moves the epoch on for the next launch. The wrappers keep one
//     buffer per device and stream for every chained scan (launches on a
//     stream run in order), so no launch clears anything first, and a
//     captured CUDA graph replays correctly. After 2^30 - 1 launches the
//     tags wrap: that launch clears the buffer.
//   * The wrapper picks the tile from (B, N) (pext.cumsum_tile): 8192
//     elements (kRun 32) where the rows make at least 4 tiles per SM,
//     else 4096 (kRun 16), so that few rows still spread over the card.
// A wrapping sum, a max and a min are exact in any split, so the result
// does not depend on the tiling.
#pragma once

#include "async.cuh"
#include "scan.cuh"

namespace lzs {

constexpr int kChainThreads = 256;
constexpr int kChainWarps = kChainThreads / 32;
constexpr unsigned kAggregate = 1;
constexpr unsigned kPrefix = 2;
constexpr unsigned kMaxTag = (1u << 30) - 1;
constexpr unsigned kFull = 0xffffffffu;

// Element of register r of this thread within its tile (striped).
template <int kRun>
__device__ __forceinline__ int striped(int r) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  return warp * 32 * kRun + (r >> 2) * 128 + lane * 4 + (r & 3);
}

__device__ __forceinline__ unsigned long long status(unsigned tag,
                                                     unsigned flag,
                                                     int value) {
  return static_cast<unsigned long long>(tag << 2 | flag) << 32 |
         static_cast<unsigned>(value);
}

__device__ __forceinline__ void publish(unsigned long long* word,
                                        unsigned long long w) {
  *reinterpret_cast<volatile unsigned long long*>(word) = w;
}

// This launch's tag: 1 + the epoch in the first word. A CTA reads it
// before it counts itself done.
__device__ __forceinline__ unsigned launch_tag(
    const unsigned long long* words) {
  return 1 + *reinterpret_cast<const volatile unsigned*>(words);
}

// One thread of the CTA, once the CTA has published its status words:
// counts the CTA done and returns the count before it (read it after the
// CTA's stores, in end_launch).
__device__ __forceinline__ unsigned count_done(unsigned long long* words,
                                               unsigned tag) {
  // the wrapping launch clears the words: its prefixes land first
  if (tag == kMaxTag) __threadfence();
  return atomicAdd(reinterpret_cast<unsigned*>(words) + 1, 1u);
}

// The same thread, last: the last CTA (every CTA has read the epoch)
// moves the epoch on, none done; the wrapping launch clears the status
// words words[1 .. capacity] first.
__device__ __forceinline__ void end_launch(unsigned long long* words,
                                           int capacity, unsigned tag,
                                           unsigned done) {
  if (done != gridDim.x - 1) return;
  if (tag == kMaxTag) {
    __threadfence();
    for (int i = 1; i <= capacity; ++i) words[i] = 0;
  }
  publish(words, tag == kMaxTag ? 0 : tag);
}

// Warp 0: the scan of the row's elements over the walk steps before
// `step`, whose status words start at `words`. Every lane returns it.
template <class Op>
__device__ __forceinline__ int look_back(const unsigned long long* words,
                                         int step, unsigned tag) {
  const int lane = threadIdx.x & 31;
  const Op op{};
  int prefix = Op::identity;
  for (int k = step - 1;; k -= 32) {
    const int idx = k - lane;           // lane 0 reads the nearest step
    unsigned long long w;
    unsigned flag;
    do {
      // before the walk's first step: a prefix of the identity
      w = idx >= 0
              ? *reinterpret_cast<const volatile unsigned long long*>(words +
                                                                      idx)
              : status(tag, kPrefix, Op::identity);
      const unsigned hi = static_cast<unsigned>(w >> 32);
      flag = hi >> 2 == tag ? hi & 3 : 0;
    } while (__any_sync(kFull, flag == 0));
    const unsigned prefixes = __ballot_sync(kFull, flag == kPrefix);
    // up to the nearest prefix (lane `last`), or all 32 aggregates
    const int last = prefixes ? __ffs(prefixes) - 1 : 31;
    int part = lane <= last ? static_cast<int>(static_cast<unsigned>(w))
                            : Op::identity;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1)
      part = op(part, __shfl_xor_sync(kFull, part, d));
    prefix = op(prefix, part);
    if (prefixes) return prefix;
  }
}

// Rows of n elements; grid: rows x tiles CTAs, row-major, each row's in
// walk order; words: `capacity` + 1 words, words[0] = epoch | CTAs done
// << 32 (done 0 between launches), words[1 + i] the status of CTA i
// (capacity >= rows * tiles).
template <class Op, bool kReverse, bool kVec, int kRun, class Io>
__global__ void __launch_bounds__(kChainThreads)
chain_scan_kernel(const Io io, int n, int tiles,
                  unsigned long long* __restrict__ words, int capacity) {
  constexpr int kTileN = kChainThreads * kRun;
  __shared__ int warp_tot[kChainWarps];
  __shared__ int tile_prefix;
  // kPlanes planes of kTileN / 4 slots: group r / 4 of thread t in slot
  // (r / 4) * kChainThreads + t of each
  extern __shared__ int4 planes[];
  constexpr int kStride = kTileN / 4;
  const int step = static_cast<int>(blockIdx.x % tiles);
  const int tile = kReverse ? tiles - 1 - step : step;
  const int64_t row = blockIdx.x / tiles;
  const int lo = tile * kTileN;
  const int lim = min(n - lo, kTileN);
  const int64_t base = row * n + lo;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const Op op{};
  const Io rio = io.bind(row);
  unsigned long long* const tile_words = words + 1;
  // this launch's tag (warp 0 publishes and looks back)
  const unsigned tag = threadIdx.x < 32 ? launch_tag(words) : 0;

  int4* const slots = planes + threadIdx.x;
  if constexpr (Io::kPlanes > 0) {
#pragma unroll
    for (int r = 0; r < kRun; r += 4) {
      const int e = striped<kRun>(r);
      if (kVec && e + 4 <= lim)
        rio.stage(base + e, lo + e, slots + (r / 4) * kChainThreads,
                  kStride);
    }
    cp_async_wait_all();             // this thread's own slots
  }
  int v[kRun];
  typename Io::Kept kept[kRun / 4];
#pragma unroll
  for (int r = 0; r < kRun; r += 4) {
    const int e = striped<kRun>(r);
    rio.load(base + e, lo + e, kVec && e + 4 <= lim, min(max(lim - e, 0), 4),
             Op::identity, &v[r], kept[r / 4], slots + (r / 4) * kChainThreads,
             kStride);
  }
  // each group of 4 in walk order: in the thread, then across the warp
  int warp_part = Op::identity;
#pragma unroll
  for (int i = 0; i < kRun; i += 4) {
    const int r = kReverse ? kRun - 4 - i : i;
    int x, before, group;
    if (kReverse) {
      v[r + 2] = op(v[r + 3], v[r + 2]);
      v[r + 1] = op(v[r + 2], v[r + 1]);
      v[r] = op(v[r + 1], v[r]);
      x = v[r];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int u = __shfl_down_sync(kFull, x, d);
        if (lane + d < 32) x = op(x, u);
      }
      before = __shfl_down_sync(kFull, x, 1);
      if (lane == 31) before = Op::identity;
      group = __shfl_sync(kFull, x, 0);
    } else {
      v[r + 1] = op(v[r], v[r + 1]);
      v[r + 2] = op(v[r + 1], v[r + 2]);
      v[r + 3] = op(v[r + 2], v[r + 3]);
      x = v[r + 3];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int u = __shfl_up_sync(kFull, x, d);
        if (lane >= d) x = op(x, u);
      }
      before = __shfl_up_sync(kFull, x, 1);
      if (lane == 0) before = Op::identity;
      group = __shfl_sync(kFull, x, 31);
    }
    // the warp's part before this lane's group in walk order
    before = op(warp_part, before);
    warp_part = op(warp_part, group);
#pragma unroll
    for (int j = 0; j < 4; ++j) v[r + j] = op(before, v[r + j]);
    if constexpr (Io::kExclusive) {
      if (kReverse) {
        v[r] = v[r + 1];
        v[r + 1] = v[r + 2];
        v[r + 2] = v[r + 3];
        v[r + 3] = before;
      } else {
        v[r + 3] = v[r + 2];
        v[r + 2] = v[r + 1];
        v[r + 1] = v[r];
        v[r] = before;
      }
    }
  }
  // the warps: each one's part before it in walk order, and the tile's
  if (lane == 0) warp_tot[warp] = warp_part;
  __syncthreads();
  int warp_before = Op::identity, total = Op::identity;
#pragma unroll
  for (int k = 0; k < kChainWarps; ++k) {
    const int t = warp_tot[k];
    if (kReverse ? k > warp : k < warp) warp_before = op(warp_before, t);
    total = op(total, t);
  }

  unsigned long long* word = tile_words + blockIdx.x;
  unsigned done = 0;
  if (threadIdx.x < 32) {
    int before = Op::identity;
    if (step == 0) {
      if (threadIdx.x == 0) publish(word, status(tag, kPrefix, total));
    } else {
      if (threadIdx.x == 0) publish(word, status(tag, kAggregate, total));
      before = look_back<Op>(tile_words + row * tiles, step, tag);
      if (threadIdx.x == 0)
        publish(word, status(tag, kPrefix, op(before, total)));
    }
    if (threadIdx.x == 0) {
      tile_prefix = before;
      done = count_done(words, tag);
    }
  }
  __syncthreads();
  const int off = op(tile_prefix, warp_before);
#pragma unroll
  for (int r = 0; r < kRun; r += 4) {
    const int e = striped<kRun>(r);
    const int s[4] = {op(off, v[r]), op(off, v[r + 1]), op(off, v[r + 2]),
                      op(off, v[r + 3])};
    rio.store(base + e, lo + e, kVec && e + 4 <= lim,
              min(max(lim - e, 0), 4), s, kept[r / 4],
              slots + (r / 4) * kChainThreads, kStride);
  }
  if (threadIdx.x == 0) end_launch(words, capacity, tag, done);
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Launches the chained scan of `rows` rows of n elements through `io`.
// tile: 4096 or 8192 elements per CTA; words: capacity + 1 int64 words,
// zeroed when made and then only ever passed to the chained scans, by
// launches that run one at a time; capacity >= rows * ceil(n / tile).
// vec: n % 4 == 0 and every row operand 16-byte aligned.
template <class Op, bool kReverse, class Io>
int chain_rows(const Io& io, bool vec, int rows, int n, int tile,
               void* words, int capacity, int device, void* stream) {
  const DeviceGuard guard(device);
  auto* w = static_cast<unsigned long long*>(words);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = (n + tile - 1) / tile;
  const unsigned grid = static_cast<unsigned>(rows) * tiles;
  if (static_cast<int64_t>(grid) > capacity)
    return static_cast<int>(cudaErrorInvalidValue);
  // the staged planes: 16 or 32 KiB each, past the 48 KiB default
  const int smem = Io::kPlanes * tile * 4;
#define LZS_CHAIN(VEC, RUN)                                                 \
  do {                                                                      \
    auto kernel = chain_scan_kernel<Op, kReverse, VEC, RUN, Io>;            \
    if (smem > 0) {                                                         \
      const cudaError_t err = cudaFuncSetAttribute(                         \
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);       \
      if (err != cudaSuccess) return static_cast<int>(err);                 \
    }                                                                       \
    kernel<<<grid, kChainThreads, smem, s>>>(io, n, tiles, w, capacity);    \
  } while (0)
  if (tile == kChainThreads * 16) {
    if (vec) LZS_CHAIN(true, 16); else LZS_CHAIN(false, 16);
  } else if (tile == kChainThreads * 32) {
    if (vec) LZS_CHAIN(true, 32); else LZS_CHAIN(false, 32);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#undef LZS_CHAIN
  return static_cast<int>(cudaGetLastError());
}

}  // namespace lzs
