// Tier 1 of the match search's probe (sortmatch._probe_batch), one launch
// a wave, over the wave's sorted lane keys srt (B, P): a key is
// i << 15 | doff, or 0x7FFFFFFF for an empty lane (the empty lanes sort to
// each row's end). For a live lane:
//
//   cbase = i + cap, a = min(cbase, N - 1), d = max(doff, 1),
//   bpos = a - min(d, a)
//   ext  = the leading equal bytes of x[a ..] and x[bpos ..] over the
//          48-byte span (bytes at or past N read 0)
//   cln  = min(ext, max(n - cbase, 0))
//   dact = d where ext == 48 and cbase + cln < n (the run goes on past
//          the span: tier 2 closes it at offset d), else 0x3FFFFFFF
//
// and for an empty lane cln = 0, dact = 0x3FFFFFFF.
//
// Replaces no pallas_call of its own: JAX fetches both spans' words with
// K10 (lzs_tpu/ops/sortmatch.py:445, gather_big over a big-endian word
// array of the rows) and compares them in jnp that XLA fuses. The port
// ran that as int64 torch passes over all B x P lanes of a wave (the word
// array, the span indices, the 26-word gather, the byte alignment, a
// 25-pass clz, an argmax), though on short rows fewer than 1% of the
// lanes are live.
//
// Bound: memory. Every lane reads its key and writes cln and dact (12
// bytes); a live lane reads its two spans, 2 x 48 byte values of 4
// bytes, which its neighbours' spans overlap (the lanes of a row sort by
// position), so they come mostly from L1 and L2.
//
// Design: a thread a lane, a flat grid over the B x P lanes, 256 threads
// a CTA. An empty lane stores its two words and leaves after one load, so
// a CTA of empty lanes costs a load and two stores a thread. A live lane
// compares its spans straight from x, four byte pairs a step (eight loads
// in flight), and stops at the first step with a differing byte; nothing
// goes through device memory between the load of x and the two stores.
#include "scan.cuh"

namespace {

constexpr int kProbeThreads = 256;
constexpr int kNoLane = 0x7FFFFFFF;   // sortmatch._NO_LANE
constexpr int kBig = 0x3FFFFFFF;      // sortmatch._BIG
constexpr int kSpan = 48;             // sortmatch._T1_WORDS words of 4

__device__ __forceinline__ unsigned byte_at(const int* row, int j, int npos) {
  return j < npos ? static_cast<unsigned char>(__ldg(row + j)) : 0u;
}

__global__ void __launch_bounds__(kProbeThreads)
probe_span_kernel(const int* __restrict__ x, const int* __restrict__ n,
                  const int* __restrict__ srt, int* __restrict__ cln,
                  int* __restrict__ dact, int64_t total, int p, int npos,
                  int cap) {
  const int64_t f =
      static_cast<int64_t>(blockIdx.x) * kProbeThreads + threadIdx.x;
  if (f >= total) return;
  const int key = __ldg(srt + f);
  if (key >= kNoLane) {
    cln[f] = 0;
    dact[f] = kBig;
    return;
  }
  const int64_t row = f / p;
  const int* xr = x + row * npos;
  const int cbase = (key >> 15) + cap;
  const int a = min(cbase, npos - 1);
  const int d = max(key & 0x7FFF, 1);
  const int bpos = a - min(d, a);
  int ext = 0;
#pragma unroll 1
  for (int k = 0; k < kSpan; k += 4) {
    unsigned ua[4], ub[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      ua[u] = byte_at(xr, a + k + u, npos);
      ub[u] = byte_at(xr, bpos + k + u, npos);
    }
    int eq = 4;
#pragma unroll
    for (int u = 3; u >= 0; --u) {
      if (ua[u] != ub[u]) eq = u;
    }
    ext += eq;
    if (eq < 4) break;
  }
  const int nrow = __ldg(n + row);
  const int c = min(ext, max(nrow - cbase, 0));
  cln[f] = c;
  dact[f] = ext >= kSpan && cbase + c < nrow ? d : kBig;
}

}  // namespace

LZS_API int lzs_probe_span(const int* x, const int* n, const int* srt,
                           int* cln, int* dact, int rows, int p, int npos,
                           int cap, int device, void* stream) {
  const lzs::DeviceGuard guard(device);
  const int64_t total = static_cast<int64_t>(rows) * p;
  const auto blocks =
      static_cast<unsigned>((total + kProbeThreads - 1) / kProbeThreads);
  probe_span_kernel<<<blocks, kProbeThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      x, n, srt, cln, dact, total, p, npos, cap);
  return static_cast<int>(cudaGetLastError());
}
