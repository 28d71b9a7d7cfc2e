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
// scanned across the CTA, a carry threading the tiles together. The match
// search's fused scans (cand.cu, extend.cu) are other load/store policies
// of the same walk.
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
// pads the row's ragged end.
//   * A CTA of 256 threads loads its tile of 256 * kRun elements with
//     16-byte loads, warp-striped: register group g of lane l of warp w
//     holds the 4 elements at w * 32 * kRun + g * 128 + l * 4, so each
//     load of a warp reads 512 consecutive bytes. (Runs of consecutive
//     elements per thread put the lanes 64 bytes apart, so that each load
//     touches twice the sectors it uses: slower, PERF.md.)
//     Scalar loads serve a row that is not 16-byte aligned and the row's
//     ragged end. Each group is scanned in the thread and across the warp
//     with shuffles; the 8 warp totals, from shared memory, give the
//     tile's total and each warp's offset.
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
//     CTA moves the epoch on for the next launch. The wrapper keeps one
//     buffer per device and stream for all three scans (launches on a
//     stream run in order), so no launch clears anything first, and a
//     captured CUDA graph replays correctly. After 2^30 - 1 launches the
//     tags wrap: that launch clears the buffer.
//   * The wrapper picks the tile from (B, N): 8192 elements (kRun 32) where
//     the rows make at least 4 tiles per SM, else 4096 (kRun 16), so that
//     few rows still spread over the card.
// The sum wraps modulo 2^32 like an int32 sum in torch, and max and min
// are exact, so any split gives the same bits.
#include "scan.cuh"

namespace {

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

// in, out: int32[rows, n]; grid: rows x tiles CTAs, row-major, each row's
// in walk order; words: `capacity` + 1 words, words[0] = epoch | CTAs
// done << 32 (done 0 between launches), words[1 + i] the status of CTA i
// (capacity >= rows * tiles).
template <class Op, bool kReverse, bool kVec, int kRun>
__global__ void __launch_bounds__(kChainThreads)
chain_scan_kernel(const int* __restrict__ in, int* __restrict__ out, int n,
                  int tiles, unsigned long long* __restrict__ words,
                  int capacity) {
  constexpr int kTileN = kChainThreads * kRun;
  __shared__ int warp_tot[kChainWarps];
  __shared__ int tile_prefix;
  const int step = static_cast<int>(blockIdx.x % tiles);
  const int tile = kReverse ? tiles - 1 - step : step;
  const int64_t row = blockIdx.x / tiles;
  const int lo = tile * kTileN;
  const int lim = min(n - lo, kTileN);
  const int* src = in + row * n + lo;
  int* dst = out + row * n + lo;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const Op op{};
  unsigned* const control = reinterpret_cast<unsigned*>(words);
  unsigned long long* const tile_words = words + 1;
  // this launch's tag (warp 0 publishes and looks back)
  const unsigned tag =
      threadIdx.x < 32 ? 1 + *reinterpret_cast<volatile unsigned*>(control)
                       : 0;

  int v[kRun];
#pragma unroll
  for (int r = 0; r < kRun; r += 4) {
    const int e = striped<kRun>(r);
    if (kVec && e + 4 <= lim) {
      const int4 w4 = *reinterpret_cast<const int4*>(src + e);
      v[r] = w4.x;
      v[r + 1] = w4.y;
      v[r + 2] = w4.z;
      v[r + 3] = w4.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[r + j] = e + j < lim ? src[e + j] : Op::identity;
    }
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
      // the wrapping launch clears the words: its prefixes land first
      if (tag == kMaxTag) __threadfence();
      done = atomicAdd(control + 1, 1u);   // read after the stores
    }
  }
  __syncthreads();
  const int off = op(tile_prefix, warp_before);
#pragma unroll
  for (int r = 0; r < kRun; r += 4) {
    const int e = striped<kRun>(r);
    if (kVec && e + 4 <= lim) {
      *reinterpret_cast<int4*>(dst + e) =
          make_int4(op(off, v[r]), op(off, v[r + 1]), op(off, v[r + 2]),
                    op(off, v[r + 3]));
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (e + j < lim) dst[e + j] = op(off, v[r + j]);
    }
  }
  // the last CTA: every CTA has read the epoch; move it on, none done
  if (threadIdx.x == 0 && done == gridDim.x - 1) {
    if (tag == kMaxTag) {
      __threadfence();
      for (int i = 1; i <= capacity; ++i) words[i] = 0;
    }
    publish(words, tag == kMaxTag ? 0 : tag);
  }
}

template <class Op, bool kReverse, bool kVec>
cudaError_t launch_chain(const int* in, int* out, int rows, int n, int tile,
                         unsigned long long* words, int capacity,
                         cudaStream_t stream) {
  const int tiles = (n + tile - 1) / tile;
  const unsigned grid = static_cast<unsigned>(rows) * tiles;
  if (static_cast<int64_t>(grid) > capacity) return cudaErrorInvalidValue;
  if (tile == kChainThreads * 16) {
    chain_scan_kernel<Op, kReverse, kVec, 16>
        <<<grid, kChainThreads, 0, stream>>>(in, out, n, tiles, words,
                                             capacity);
  } else if (tile == kChainThreads * 32) {
    chain_scan_kernel<Op, kReverse, kVec, 32>
        <<<grid, kChainThreads, 0, stream>>>(in, out, n, tiles, words,
                                             capacity);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// tile: 4096 or 8192 elements per CTA; words: capacity + 1 int64 words,
// zeroed when made and then only ever passed to the chained scans, by
// launches that run one at a time; capacity >= rows * ceil(n / tile).
template <class Op, bool kReverse>
int chain_rows(const int* in, int* out, int rows, int n, int tile,
               void* words, int capacity, int device, void* stream) {
  const lzs::DeviceGuard guard(device);
  const bool vec = n % 4 == 0 && aligned16(in) && aligned16(out);
  auto* w = static_cast<unsigned long long*>(words);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      vec ? launch_chain<Op, kReverse, true>(in, out, rows, n, tile, w,
                                             capacity, s)
          : launch_chain<Op, kReverse, false>(in, out, rows, n, tile, w,
                                              capacity, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
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
