// The match search's gram sort keys and rank LCPs, over (B, N) rows of
// byte values, each in one flat launch:
//
//   gram_keys  key0[b, i] = bytes i..i+7 of the row, big-endian, XOR 1 << 63
//              (int64: its signed order is the bytes' order); key1[b, i] =
//              bytes i+8..i+11 XOR 1 << 31 (int32, a 12-byte gram) or bytes
//              i+8..i+15 XOR 1 << 63 (int64, a 16-byte gram); none for a
//              gram of 8 bytes or fewer. Bytes at or past N read 0, and so
//              do the bytes past the gram's length (a 4-byte gram leaves
//              key0's low word 0).
//   rank_lcp   for rows sorted by (key0, key1, position), s0 the sorted
//              key0 and perm the sorted positions: plcp[b, r] = the
//              leading equal bytes of the grams at ranks r and r - 1,
//              capped at cap, 0 at r = 0 (__clzll of the key0 XOR, then,
//              where the first 8 bytes agree, of key1[perm[r]] XOR
//              key1[perm[r - 1]]); p[b, r] = perm[b, r] as int32.
//
// Replaces no pallas_call: the JAX package builds the gram words
// (lzs_tpu/ops/sortmatch.py _gram_words, :74) and the rank LCPs
// (_rank_lcp_rows, :197) as jnp that XLA fuses, and sorts the words as
// keys of one lax.sort. torch.sort takes one key, so the port sorted three
// int64 word planes in a stable chain and built both in some 190 int64
// torch passes; the two sorts now run on these packed keys (a 32-bit and
// a 64-bit radix sort in place of three 64-bit ones), and these kernels
// compute the rest in one pass each.
//
// Bound: memory. gram_keys reads 4 bytes a position and writes 12 (16 for
// a 16-byte gram); rank_lcp reads s0 and perm and writes plcp and p (24
// bytes a rank), and reads two key1 entries only at ranks whose first 8
// bytes tie (their row is 128 KiB at most, so the gathers hit L2).
//
// Design: both grids run flat over the B x N positions, kTile = 1024 a
// CTA of 256 threads, so one row of 32768 makes 32 CTAs and 8192 rows of
// 1500 make 12000, with no CTA idle past a row's end. A position's row
// offset is the tile start's (one 64-bit remainder a thread) plus its
// index in the tile, modulo N in 32 bits. gram_keys stages the tile's
// bytes and the 15 after it in shared memory (coalesced int32 loads, one
// byte kept each) and masks the bytes past the row's end itself, since a
// tile may run across rows. Each thread takes the positions t, t + 256,
// ... of the tile, so every store of a warp is one contiguous run.
#include "scan.cuh"

namespace {

constexpr int kGramThreads = 256;
constexpr int kPer = 4;                           // positions a thread
constexpr int kTile = kGramThreads * kPer;        // positions a CTA
constexpr int kSpan = 15;                         // bytes past a position

// Bytes kLo..kHi-1 of the gram at tile position j, big-endian; bytes at or
// past `left` (the row's end, counted from j) read 0.
template <int kLo, int kHi>
__device__ __forceinline__ unsigned long long be_bytes(
    const unsigned char* s, int j, int left) {
  unsigned long long v = 0;
#pragma unroll
  for (int t = kLo; t < kHi; ++t) {
    v = (v << 8) | (t < left ? s[j + t] : 0u);
  }
  return v;
}

template <int kBytes>
__global__ void __launch_bounds__(kGramThreads)
gram_keys_kernel(const int* __restrict__ x, long long* __restrict__ key0,
                 void* __restrict__ key1, int64_t total, int n) {
  constexpr int kHead = kBytes < 8 ? kBytes : 8;   // bytes in key0
  __shared__ unsigned char s[kTile + kSpan];
  const int64_t f0 = static_cast<int64_t>(blockIdx.x) * kTile;
  for (int j = threadIdx.x; j < kTile + kSpan; j += kGramThreads) {
    s[j] = f0 + j < total ? static_cast<unsigned char>(__ldg(x + f0 + j))
                          : 0;
  }
  const int i0 = static_cast<int>(f0 % n);
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int j = threadIdx.x + k * kGramThreads;
    const int64_t f = f0 + j;
    if (f >= total) break;
    const int left = n - (i0 + j) % n;
    const unsigned long long head = be_bytes<0, kHead>(s, j, left)
                                    << (8 * (8 - kHead));
    key0[f] = static_cast<long long>(head ^ (1ull << 63));
    if (kBytes == 12) {
      const unsigned tail =
          static_cast<unsigned>(be_bytes<8, 12>(s, j, left));
      static_cast<int*>(key1)[f] = static_cast<int>(tail ^ (1u << 31));
    } else if (kBytes == 16) {
      static_cast<long long*>(key1)[f] =
          static_cast<long long>(be_bytes<8, 16>(s, j, left) ^ (1ull << 63));
    }
  }
}

// kKey1: the bytes of a key1 entry, 0 where there is no key1.
template <int kKey1>
__global__ void __launch_bounds__(kGramThreads)
rank_lcp_kernel(const long long* __restrict__ s0,
                const void* __restrict__ key1,
                const long long* __restrict__ perm, int* __restrict__ plcp,
                int* __restrict__ p, int64_t total, int n, int cap) {
  const int64_t f0 = static_cast<int64_t>(blockIdx.x) * kTile;
  const int i0 = static_cast<int>(f0 % n);
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int j = threadIdx.x + k * kGramThreads;
    const int64_t f = f0 + j;
    if (f >= total) break;
    const int r = (i0 + j) % n;
    const long long here = __ldg(perm + f);
    int lcp = 0;
    if (r > 0) {
      lcp = __clzll(__ldg(s0 + f) ^ __ldg(s0 + f - 1)) >> 3;
      if (kKey1 != 0 && lcp == 8) {
        const int64_t base = f - r;
        const long long prev = __ldg(perm + f - 1);
        if (kKey1 == 4) {
          const int* k1 = static_cast<const int*>(key1) + base;
          lcp += __clz(__ldg(k1 + here) ^ __ldg(k1 + prev)) >> 3;
        } else {
          const long long* k1 = static_cast<const long long*>(key1) + base;
          lcp += __clzll(__ldg(k1 + here) ^ __ldg(k1 + prev)) >> 3;
        }
      }
      lcp = min(lcp, cap);
    }
    plcp[f] = lcp;
    p[f] = static_cast<int>(here);
  }
}

unsigned tiles(int64_t total) {
  return static_cast<unsigned>((total + kTile - 1) / kTile);
}

}  // namespace

LZS_API int lzs_gram_keys(const int* x, long long* key0, void* key1,
                          int rows, int n, int nbytes, int device,
                          void* stream) {
  const lzs::DeviceGuard guard(device);
  const int64_t total = static_cast<int64_t>(rows) * n;
  const auto s = static_cast<cudaStream_t>(stream);
  switch (nbytes) {
    case 4:
      gram_keys_kernel<4><<<tiles(total), kGramThreads, 0, s>>>(
          x, key0, key1, total, n);
      break;
    case 8:
      gram_keys_kernel<8><<<tiles(total), kGramThreads, 0, s>>>(
          x, key0, key1, total, n);
      break;
    case 12:
      gram_keys_kernel<12><<<tiles(total), kGramThreads, 0, s>>>(
          x, key0, key1, total, n);
      break;
    case 16:
      gram_keys_kernel<16><<<tiles(total), kGramThreads, 0, s>>>(
          x, key0, key1, total, n);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

LZS_API int lzs_rank_lcp(const long long* s0, const void* key1,
                         const long long* perm, int* plcp, int* p, int rows,
                         int n, int key1_bytes, int cap, int device,
                         void* stream) {
  const lzs::DeviceGuard guard(device);
  const int64_t total = static_cast<int64_t>(rows) * n;
  const auto s = static_cast<cudaStream_t>(stream);
  switch (key1_bytes) {
    case 0:
      rank_lcp_kernel<0><<<tiles(total), kGramThreads, 0, s>>>(
          s0, key1, perm, plcp, p, total, n, cap);
      break;
    case 4:
      rank_lcp_kernel<4><<<tiles(total), kGramThreads, 0, s>>>(
          s0, key1, perm, plcp, p, total, n, cap);
      break;
    case 8:
      rank_lcp_kernel<8><<<tiles(total), kGramThreads, 0, s>>>(
          s0, key1, perm, plcp, p, total, n, cap);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
