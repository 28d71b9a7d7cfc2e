// The raw decoder's heads stage (bitpar._heads) in one pass: at every bit
// of every row, the speculative token head that starts there -- the bits
// to its successor, whether it fits the input, its output length and its
// low bits -- with the sum of the extension-nibble chain that it enters.
//
// Replaces: no Pallas kernel. JAX computes these fields as XLA-fused jnp
// inside lzs_tpu/ops/bitpar.py decode_batch_bits (lines 155-218; its
// comment records that a Pallas roll scan was slower there), and the
// port's plain version (bitpar._heads_plain) as about a hundred torch
// passes over [B, 8 * C] planes: the bit windows, a reverse cummin (K7)
// and a cumsum (K9) for the chains, a gather and a select per field.
//
// Bound: the bytes written. Four planes a bit -- delta int32, head_ok
// bool, length int32, low int32: 13 bytes -- against 1/8 byte read: 1.75
// GB for the IPComp burst's 8192 rows of 2048 bytes, 0.52 ms at 3.35 TB/s.
// A head's fields are some 40 int32 operations a bit, below that bound.
// So every plane is written once, in 16-byte stores (4 bytes for
// head_ok), and nothing between the fields and the stores leaves the SM.
//
// Design: one CTA of 512 threads per tile of 16384 bits (2048 bytes) of a
// row; a row has as many tiles as its width needs, so the burst's rows
// are one tile each and an input window's span (8 MiB) is 4097.
//   * The tile's bytes and a tail (the last bits' windows read 31 bits on)
//     are loaded once into shared memory as big-endian words (a register
//     load and a byte swap: 2 KiB a CTA, 1% of the bytes moved); a bit's
//     32-bit window is then a funnel shift of two words.
//   * Chains: y(s) = a(s) + g(s) * y(s + 4), with a(s) the nibble at bit
//     s where it fits the input (else 0) and g(s) = (a(s) == 15), steps by
//     4 bits, so each phase class (s mod 4) is a chain of its own. A
//     thread takes 32 consecutive bits and folds them from its last one,
//     storing each bit's value as if the chain ended after the thread (the
//     true value but for a trailing run of 15s); the threads' maps
//     x -> A + G * x (G: every nibble of the class a 15) compose in a
//     reverse scan over the CTA, and the thread's trailing runs take the
//     value after it. The values sit in shared memory, one word of padding
//     every 32, so that the threads' strided stores hit distinct banks.
//   * Across tiles: a head at bit t reads the chain at t + need, at most
//     17 bits on, so a tile's chains run over its bits and the next tile's
//     first 16 (which that tile recomputes), and a tile's state is its
//     chain value at its bits 16 .. 19, one per phase class. The tiles
//     chain it by chain.cuh's decoupled look-back (K7-K9's), walked from
//     the row's end, one status word per phase class: a class that holds
//     a nibble other than a continuing 15 knows its value at once and
//     publishes it as a prefix; a class of 15s alone publishes 15 a nibble
//     as an aggregate, to which the look-back adds the tiles after it. The
//     values stay sums, so the look-back adds them as K9's does, and a
//     chain of any length is exact. A row of one tile never looks back.
//   * Heads: each thread forms 4 consecutive bits at a time, warp-striped,
//     so a warp stores 512 consecutive bytes of each int32 plane and 128
//     of head_ok, and reads the chain value at t + need from shared memory
//     where a head enters a chain. The continuation head of an input window
//     (carry: bit, offset) is written by the thread of its bit.
//
// int32 throughout: a row holds at most 2^29 bits (MAX_WIDE_INPUT bytes),
// so a chain's sum (15 a nibble) and a successor stay below 2^31, where
// the plain version's int32 sums would wrap.
#include "chain.cuh"

namespace {

constexpr int kHeadsThreads = 512;
constexpr int kHeadsWarps = kHeadsThreads / 32;
constexpr int kRunBits = 32;                          // a thread's bits
constexpr int kTileBits = kHeadsThreads * kRunBits;   // 16384
// bits of a tile before the bits whose chain values it publishes
constexpr int kLead = 16;
// the tile's words and the tail that its last windows read
constexpr int kWords = kTileBits / 32 + 1;
// chain values at the tile's bits 0 .. kTileBits + kLead
constexpr int kChainBits = kTileBits + kLead + 1;
constexpr int kChainWords = kChainBits + kChainBits / 32 + 1;
constexpr int kExtend = 15;        // spec.MAX_EXTENDED_LENGTH
// a map x -> A + G * x, packed G << 31 | A (A < 2^31 inside a tile)
constexpr unsigned kAll = 0x80000000u;
constexpr unsigned kSum = 0x7fffffffu;

__device__ __forceinline__ int slot(int bit) { return bit + (bit >> 5); }

// The map of `first` and then `then` (the chain after it).
__device__ __forceinline__ unsigned compose(unsigned first, unsigned then) {
  const unsigned sum = (first & kSum) + ((first & kAll) ? then & kSum : 0u);
  return sum | (first & then & kAll);
}

__device__ __forceinline__ int apply(unsigned map, int x) {
  return static_cast<int>(map & kSum) + ((map & kAll) ? x : 0);
}

struct HeadsArgs {
  const unsigned char* comp;   // [rows, c]; bytes past c read 0
  const int* inbits;           // [rows]
  const int* carry_bit;        // [rows], or null: no continuation heads
  const int* carry_off;        // [rows]: the copy's offset, -1 for none
  int* delta;                  // the planes, [rows, nbits]
  unsigned char* ok;
  int* length;
  int* low;
  unsigned long long* words;   // chain.cuh's status words (tiles > 1)
  int capacity;                // ... words[1 .. capacity]
  int c, nbits, tiles, out_cap;
  bool multi;                  // end markers jump to the next byte
  bool aligned;                // every row's bytes start 4-byte aligned
};

// grid: rows x tiles CTAs, each row's tiles from its end (blockIdx.x %
// tiles is the walk step); status words: 4 per CTA, class q's at
// words[1 + q * gridDim.x + blockIdx.x].
__global__ void __launch_bounds__(kHeadsThreads, 2)
heads_kernel(const HeadsArgs p) {
  extern __shared__ int chain[];       // kChainWords
  __shared__ unsigned bits[kWords];
  __shared__ unsigned warp_map[4][kHeadsWarps];
  __shared__ int after[4];             // chain values kTileBits + kLead on
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int step = static_cast<int>(blockIdx.x % p.tiles);
  const int64_t row = blockIdx.x / p.tiles;
  const int lo = (p.tiles - 1 - step) * kTileBits;
  const int lim = min(p.nbits - lo, kTileBits);
  const int inbits = __ldg(p.inbits + row);
  const bool chained = p.tiles > 1;
  // warps 0-3 publish and look back, one phase class each
  const unsigned tag = chained && warp < 4 ? lzs::launch_tag(p.words) : 0;

  // the tile's bytes from bit lo on, as the plain version reads them:
  // zero past the row and past its padded width's 4-byte tail
  const unsigned char* const src = p.comp + row * p.c;
  const int end = min(p.c, p.nbits / 8 + 4);
  for (int i = tid; i < kWords; i += kHeadsThreads) {
    const int at = lo / 8 + 4 * i;
    unsigned w = 0;
    if (p.aligned && at + 4 <= end) {
      w = __byte_perm(__ldg(reinterpret_cast<const unsigned*>(src + at)), 0,
                      0x0123);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        w = w << 8 | (at + j < end ? __ldg(src + at + j) : 0u);
    }
    bits[i] = w;
  }
  __syncthreads();

  // chains: this thread's bits kLead + 32 tid .. + 31 of the tile, from
  // its last; a nibble counts where it lies in the input and the row
  const int first = kLead + kRunBits * tid;
  const unsigned long long pair =
      static_cast<unsigned long long>(bits[tid]) << 32 | bits[tid + 1];
  const int fits = min(inbits - 3 - (lo + first), p.nbits - (lo + first));
  int run[4] = {0, 0, 0, 0};
  bool all[4] = {true, true, true, true};
  int tail[4] = {0, 0, 0, 0};          // the trailing run of 15s
#pragma unroll
  for (int j = kRunBits - 1; j >= 0; --j) {
    const int q = j & 3;
    const int v = j < fits ? static_cast<int>(pair >> (44 - j) & 15) : 0;
    const bool go = v == kExtend;
    run[q] = go ? run[q] + kExtend : v;
    all[q] = all[q] && go;
    tail[q] += all[q];
    chain[slot(first + j)] = run[q];
  }
  // each class's map over the threads after this one (`later`)
  unsigned later[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    unsigned x = (all[q] ? kAll : 0u) | static_cast<unsigned>(run[q]);
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const unsigned o = __shfl_down_sync(lzs::kFull, x, d);
      if (lane + d < 32) x = compose(x, o);
    }
    later[q] = __shfl_down_sync(lzs::kFull, x, 1);
    if (lane == 31) later[q] = kAll;
    if (lane == 0) warp_map[q][warp] = x;
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    unsigned warps_after = kAll;
    for (int w = kHeadsWarps - 1; w > warp; --w)
      warps_after = compose(warp_map[q][w], warps_after);
    later[q] = compose(later[q], warps_after);
  }

  // the chain values kLead + q bits past the tile: 0 past the row's end,
  // else the next tile's state, by the look-back
  unsigned done = 0;
  if (warp < 4) {
    const int q = warp;
    unsigned total = kAll;
    for (int w = kHeadsWarps - 1; w >= 0; --w)
      total = compose(warp_map[q][w], total);
    int next = 0;
    if (chained) {
      unsigned long long* const own =
          p.words + 1 + static_cast<int64_t>(q) * gridDim.x;
      unsigned long long* const word = own + blockIdx.x;
      const int sum = static_cast<int>(total & kSum);
      const bool open = (total & kAll) != 0 && step > 0;
      if (lane == 0)
        lzs::publish(word, lzs::status(tag, open ? lzs::kAggregate
                                                 : lzs::kPrefix, sum));
      if (step > 0) {
        next = lzs::look_back<lzs::AddOp>(own + row * p.tiles, step, tag);
        if (lane == 0 && open)
          lzs::publish(word, lzs::status(tag, lzs::kPrefix, sum + next));
      }
    }
    if (lane == 0) after[q] = next;
  }
  __syncthreads();
  if (chained && tid == 0) done = lzs::count_done(p.words, tag);
  // the trailing runs take the value after the thread
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int add = apply(later[q], after[q]);
#pragma unroll
    for (int i = 0; i < kRunBits / 4; ++i)
      if (i < tail[q] && add != 0)
        chain[slot(first + kRunBits - 4 + q - 4 * i)] += add;
  }
  if (tid == 0) chain[slot(kTileBits + kLead)] = after[0];
  __syncthreads();
  // the lead bits, from the chain values after them
  if (tid < 4) {
    const unsigned long long head =
        static_cast<unsigned long long>(bits[0]) << 32 | bits[1];
    const int lead_fits = min(inbits - 3 - lo, p.nbits - lo);
    int y = chain[slot(kLead + tid)];
    for (int r = kLead - 4 + tid; r >= 0; r -= 4) {
      const int v = r < lead_fits ? static_cast<int>(head >> (60 - r) & 15)
                                  : 0;
      y = v == kExtend ? y + kExtend : v;
      chain[slot(r)] = y;
    }
  }
  __syncthreads();

  // heads: 4 consecutive bits a group, warp-striped
  int carry_at = -1, carry_off = -1;
  if (p.carry_bit != nullptr) {
    carry_at = __ldg(p.carry_bit + row) - lo;
    carry_off = __ldg(p.carry_off + row);
  }
  const int64_t out = row * p.nbits + lo;
#pragma unroll
  for (int g = 0; g < kRunBits / 4; ++g) {
    const int e = warp * 32 * kRunBits + g * 128 + lane * 4;
    if (e >= lim) continue;            // lim is a multiple of 8
    const unsigned long long win =
        static_cast<unsigned long long>(bits[e >> 5]) << 32 |
        bits[(e >> 5) + 1];
    int d[4], n[4], l[4];
    unsigned okw = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = e + j;
      const int t = lo + r;
      const unsigned w = static_cast<unsigned>(win >> (32 - (r & 31)));
      // the head's fields (lzs-decompression.c:214-343)
      const bool lit = (w >> 31) == 0;
      const bool near = ((w >> 30) & 1) != 0;
      const int off7 = (w >> 23) & 0x7F;
      const int l4 = near ? (w >> 19) & 15 : (w >> 15) & 15;
      const bool long_len = (l4 >> 2) == 3;
      const int init = long_len ? (l4 & 3) + 5 : (l4 >> 2) + 2;
      const bool marker = !lit && near && off7 == 0;
      const bool match = !lit && !marker;
      const int need = lit || marker ? 9 : (near ? 9 : 13) + (long_len ? 4 : 2);
      const bool enters = match && l4 == 15;
      // the chain starts right after the head
      const int ext = enters ? chain[slot(r + need)] : 0;
      bool fit = t + need <= inbits;
      int len = lit ? 1 : marker ? 0 : init + ext;
      const int succ = !fit    ? p.nbits
                       : marker ? (p.multi ? (t + 16) & ~7 : p.nbits)
                                : t + need + (enters ? 4 * (ext / 15 + 1) : 0);
      int delta = max(succ - t, 1);
      int low = (match ? 1 << 11 : 0) |
                (lit ? (w >> 23) & 0xFF : near ? off7 : (w >> 19) & 0x7FF);
      if (r == carry_at && carry_off >= 0) {
        // a copy continued at its bit: no fields, its chain starts there
        const int y = chain[slot(r)];
        delta = 4 * (y / 15 + 1);
        fit = t <= inbits;
        len = y;
        low = 1 << 11 | carry_off;
      }
      d[j] = delta;
      n[j] = min(len, p.out_cap);
      l[j] = low;
      okw |= static_cast<unsigned>(fit) << (8 * j);
    }
    *reinterpret_cast<int4*>(p.delta + out + e) =
        make_int4(d[0], d[1], d[2], d[3]);
    *reinterpret_cast<int4*>(p.length + out + e) =
        make_int4(n[0], n[1], n[2], n[3]);
    *reinterpret_cast<int4*>(p.low + out + e) =
        make_int4(l[0], l[1], l[2], l[3]);
    *reinterpret_cast<unsigned*>(p.ok + out + e) = okw;
  }
  if (chained && tid == 0)
    lzs::end_launch(p.words, p.capacity, tag, done);
}

}  // namespace

// comp: uint8[rows, c]; inbits: int32[rows]; carry_bit, carry_off:
// int32[rows] or both null; delta, length, low: int32[rows, nbits] and ok:
// bool[rows, nbits], 16-byte aligned; nbits: a multiple of 8, at most
// 2^29; words: capacity + 1 int64 words (chain.cuh), capacity >= 4 * rows
// * ceil(nbits / 16384) where a row has more than one tile.
LZS_API int lzs_raw_heads(const unsigned char* comp, int c, const int* inbits,
                          const int* carry_bit, const int* carry_off,
                          int* delta, unsigned char* ok, int* length,
                          int* low, int rows, int nbits, int out_cap,
                          int multi, void* words, int capacity, int device,
                          void* stream) {
  const lzs::DeviceGuard guard(device);
  if (rows <= 0 || nbits <= 0 || nbits % 8 != 0 || nbits > (1 << 29) ||
      c < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (nbits + kTileBits - 1) / kTileBits;
  const int64_t grid = static_cast<int64_t>(rows) * tiles;
  if (grid > INT_MAX / 4 || (tiles > 1 && 4 * grid > capacity))
    return static_cast<int>(cudaErrorInvalidValue);
  HeadsArgs a{comp, inbits, carry_bit, carry_off, delta, ok, length, low,
              static_cast<unsigned long long*>(words), capacity, c, nbits,
              tiles,
              out_cap, multi != 0,
              c % 4 == 0 && (reinterpret_cast<uintptr_t>(comp) & 3) == 0};
  const int smem = kChainWords * static_cast<int>(sizeof(int));
  const cudaError_t err = cudaFuncSetAttribute(
      heads_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  heads_kernel<<<static_cast<unsigned>(grid), kHeadsThreads, smem,
                 static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
