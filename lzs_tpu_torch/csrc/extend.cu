// Run extension of the sort-based match search, over int32 (B, N) rows
// (N <= 32768): where a capped match (score == cap) runs on, how far.
//
//   ext_breaks  per position: capped = score >= cap && i + cap < n; a head
//               is a capped position whose predecessor is not capped or
//               has another offset; heads and uncapped positions are
//               breaks. A suffix min over the packed break info
//               (i << 13 | is_cap << 12 | off) finds the next break e
//               strictly after i, which pins the run's length (ext_res =
//               e - i - 1) unless the run touches the data end or a nearer
//               capped offset stole it (need_probe). Out: ext_res << 3 |
//               head << 2 | capped << 1 | need_probe.
//   ext_fold    a prefix max over the heads' packed (i << 16 | cap +
//               ext_h) hands each capped position its head; full = the
//               head's length minus the distance to it, score elsewhere.
//
// Replaces: lzs_tpu/ops/pext.py _break_kernel (K4) and _fold_kernel (K5),
// the Pallas roll scans with the same prologue and epilogue. The TPU
// kernels read i - 1 and i + 1 by rolling whole VMEM rows; here the
// predecessor comes straight from device memory (cached), and the
// successor's suffix min is the reverse scan's exclusive value. Past the
// row's end that value is MinOp's identity (INT_MAX) where JAX has
// 0x3FFFFFFF: both fail nxt1 < 0x3FFFFFFF, so the outputs are equal.
//
// Bound: memory. ext_breaks reads score and off and writes one plane (12
// bytes per element); ext_fold must read packed, score where not capped
// and ext_h at heads, and write one plane (12-16 bytes per element; the
// kernel moves 16).
//
// Design: ext_breaks is the row-scan walk of scan.cuh (lzs::row_scan, one
// CTA of 1024 threads per row) with the prologue fused into its load and
// the epilogue into its store. ext_fold is an instance of the chained
// scan of chain.cuh (a max forward, as K8 cummax_rows, with K8's tile
// choice: one CTA of 256 threads per 4096- or 8192-element tile, the
// tiles chained by decoupled look-back on the status words that K7-K9
// share per device and stream), through FoldIo: a group of 4 positions
// copies its 16 bytes of `packed`, `ext_h` and `score` into shared
// memory at once (cp.async, warp-striped, 96 KiB for an 8192-element
// tile), so that the three arrive in one memory latency; ext_h is read
// whole, not only at heads, because reading it where `packed` shows a
// head puts a second latency after the first (PERF.md). The group's
// scan value and its output come from the slots, one 16-byte store.
// Scalar loads and stores serve rows that are not 16-byte aligned or not
// a multiple of 4 wide. A run whose head lies in an earlier tile gets it
// from the look-back: the head's packed value is the running max there.
#include "chain.cuh"

namespace {

constexpr int kBig = 0x3FFFFFFF;

struct BreaksIo {
  const int* score;
  const int* off;
  int* out;
  int n;      // the block's length
  int npos;   // the row's width
  int cap;
  // what load read at its element, for the store
  bool head = false;
  bool capped = false;
  int my_off = 0;

  __device__ int load(int i) {
    const int s = score[i];
    my_off = off[i];
    capped = s >= cap && i + cap < n;
    head = capped;
    if (capped && i > 0) {
      const bool prev_c = score[i - 1] >= cap && i - 1 + cap < n;
      head = !prev_c || my_off != off[i - 1];
    }
    if (capped && !head) return kBig;
    return (i << 13) | (static_cast<int>(s >= cap) << 12) |
           min(max(my_off, 0), 0x7FF);
  }

  __device__ void store(int i, int, int nxt1) const {
    const bool has_brk = nxt1 < kBig;
    const int e = has_brk ? nxt1 >> 13 : npos;
    const bool steal =
        has_brk && ((nxt1 >> 12) & 1) == 1 && (nxt1 & 0x7FF) < my_off;
    const bool need_probe = head && (e + cap >= n || steal);
    const unsigned ext_res = static_cast<unsigned>(e - i - 1);
    out[i] = static_cast<int>((ext_res << 3) |
                              (static_cast<unsigned>(head) << 2) |
                              (static_cast<unsigned>(capped) << 1) |
                              static_cast<unsigned>(need_probe));
  }
};

// K5: the scanned value of a head is i << 16 | min(cap + ext_h, 0xFFFF),
// -1 elsewhere; a capped position's output is its head's length less the
// distance to it, score elsewhere. A 16-byte group stages its packed,
// ext_h and score in shared memory (planes 0, 1, 2); a ragged or
// misaligned group reads device memory (ext_h at heads only).
struct FoldIo {
  const int* packed;
  const int* ext_h;
  const int* score;
  int* out;
  int cap;
  struct Kept {
    unsigned capped;   // bit j: element j of the group is capped
  };
  static constexpr int kPlanes = 3;

  __device__ __forceinline__ void stage(int64_t at, int4* slot,
                                        int stride) const {
    lzs::cp_async16(slot, packed + at);
    lzs::cp_async16(slot + stride, ext_h + at);
    lzs::cp_async16(slot + 2 * stride, score + at);
  }

  __device__ __forceinline__ void load(int64_t at, int i, bool vec,
                                       int count, int pad, int* v,
                                       Kept& kept, const int4* slot,
                                       int stride) const {
    int p[4], e[4];
    if (vec) {
      const int4 p4 = slot[0], e4 = slot[stride];
      p[0] = p4.x;
      p[1] = p4.y;
      p[2] = p4.z;
      p[3] = p4.w;
      e[0] = e4.x;
      e[1] = e4.y;
      e[2] = e4.z;
      e[3] = e4.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[j] = j < count ? __ldg(packed + at + j) : 0;
        e[j] = (p[j] >> 2) & 1 ? __ldg(ext_h + at + j) : 0;
      }
    }
    kept.capped = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      kept.capped |= static_cast<unsigned>((p[j] >> 1) & 1) << j;
      v[j] = j < count ? -1 : pad;
      if ((p[j] >> 2) & 1)
        v[j] = ((i + j) << 16) | min(lzs::AddOp{}(cap, e[j]), 0xFFFF);
    }
  }

  __device__ __forceinline__ void store(int64_t at, int i, bool vec,
                                        int count, const int* s,
                                        const Kept& kept, const int4* slot,
                                        int stride) const {
    int r[4];
    if (vec) {
      const int4 w4 = slot[2 * stride];
      r[0] = w4.x;
      r[1] = w4.y;
      r[2] = w4.z;
      r[3] = w4.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) r[j] = j < count ? __ldg(score + at + j) : 0;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if ((kept.capped >> j) & 1)
        r[j] = (s[j] & 0xFFFF) - (i + j - (s[j] >> 16));
    }
    if (vec) {
      *reinterpret_cast<int4*>(out + at) = make_int4(r[0], r[1], r[2], r[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (j < count) out[at + j] = r[j];
    }
  }
};

__global__ void __launch_bounds__(lzs::kThreads)
ext_breaks_kernel(const int* __restrict__ score, const int* __restrict__ off,
                  const int* __restrict__ nb, int* __restrict__ out,
                  int npos, int cap) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * npos;
  BreaksIo io{score + row, off + row, out + row, nb[blockIdx.x], npos, cap};
  lzs::row_scan<lzs::MinOp, true>(npos, io);
}

}  // namespace

LZS_API int lzs_ext_breaks(const int* score, const int* off, const int* nb,
                           int* out, int rows, int npos, int cap, int device,
                           void* stream) {
  const lzs::DeviceGuard guard(device);
  ext_breaks_kernel<<<rows, lzs::kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(score, off, nb,
                                                           out, npos, cap);
  return static_cast<int>(cudaGetLastError());
}

// tile, words, capacity: as the chained row scans take them (rowscan.cu).
LZS_API int lzs_ext_fold(const int* packed, const int* ext_h,
                         const int* score, int* out, int rows, int npos,
                         int cap, int tile, void* words, int capacity,
                         int device, void* stream) {
  const bool vec = npos % 4 == 0 && lzs::aligned16(packed) &&
                   lzs::aligned16(score) && lzs::aligned16(out);
  return lzs::chain_rows<lzs::MaxOp, false>(
      FoldIo{packed, ext_h, score, out, cap}, vec, rows, npos, tile, words,
      capacity, device, stream);
}
