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
// predecessor comes from the neighbouring lane (a shuffle) or from device
// memory, and the successor's suffix min is the reverse scan's exclusive
// value. Past the row's end that value is MinOp's identity (INT_MAX)
// where JAX has 0x3FFFFFFF: both fail nxt1 < 0x3FFFFFFF, so the outputs
// are equal.
//
// Bound: memory. ext_breaks reads score and off and writes one plane (12
// bytes per element); ext_fold must read packed, score where not capped
// and ext_h at heads, and write one plane (12-16 bytes per element; the
// kernel moves 16).
//
// Design: both are instances of the chained scan of chain.cuh (one CTA of
// 256 threads per 4096- or 8192-element tile, pext.cumsum_tile, the tiles
// chained by decoupled look-back on the status words that K7-K9 share per
// device and stream), each through a load/store policy with its prologue
// in the load and its epilogue in the store. ext_breaks (BreaksIo) is a
// min walked from the row's end, as K7 rcummin_rows: a CTA takes its
// tiles from the row's end, so a tile still waits on lower blockIdx only,
// and a capped run whose head lies in an earlier tile than its next break
// gets that break through the look-back. The epilogue needs the next
// break strictly after i, so the policy asks the template for the
// exclusive scan (Io::kExclusive: the group's inclusive values shift one
// element against the walk, in registers). A group of 4 copies its 16
// bytes of score and off into shared memory (cp.async, warp-striped, 64
// KiB for an 8192-element tile) before any is read: a group that loaded
// into registers and tested its head at once held the next group's loads
// back, and a tile waited on one memory latency per group (PERF.md). The
// head test of a group's first element reads the element before it from
// the neighbouring lane's slot (the same warp, after a __syncwarp); a
// warp's first group copies that element with its own (4-byte cp.async),
// so no load waits on another. The store keeps a byte per group (capped,
// head) and reads off again from its slot. (The row-per-CTA walk it
// replaces waited on three barriers a 1024-element tile and on a second
// dependent load at capped positions.)
// ext_fold (FoldIo) is a max forward, as K8 cummax_rows: a group of 4
// positions copies its 16 bytes of `packed`, `ext_h` and `score` into
// shared memory at once (cp.async, warp-striped, 96 KiB for an
// 8192-element tile), so that the three arrive in one memory latency;
// ext_h is read whole, not only at heads, because reading it where
// `packed` shows a head puts a second latency after the first (PERF.md).
// The group's scan value and its output come from the slots, one 16-byte
// store. Scalar loads and stores serve rows that are not 16-byte aligned
// or not a multiple of 4 wide. A run whose head lies in an earlier tile
// gets it from the look-back: the head's packed value is the running max
// there.
#include "chain.cuh"

namespace {

constexpr int kBig = 0x3FFFFFFF;

// K4: per warp, the score and off of the element before the warp's first
// group (staged with the group's planes)
__shared__ int2 k4_before[lzs::kChainWarps];

// K4: the scanned value of a break (a head, or a position that is not
// capped) is i << 13 | (score >= cap) << 12 | clip(off, 0, 0x7FF), kBig
// inside a run; the store takes the exclusive suffix min, the next break
// strictly after i. A 16-byte group stages its score and off in shared
// memory (planes 0, 1); the head test of its first element reads the
// element before it there too (lane - 1's group, or lane 31's previous
// group: the same warp, after a __syncwarp), except in each warp's first
// group, which loads it from device memory. A ragged or misaligned group
// reads device memory alone.
struct BreaksIo {
  const int* score;
  const int* off;
  const int* nb;
  int* out;
  int npos;
  int cap;
  int nlim = 0;   // the row's n - cap: i is capped where i < nlim (bind)
  struct Kept {
    unsigned bits;   // bit j: element j capped; bit 4 + j: a head
  };
  static constexpr int kPlanes = 2;
  static constexpr bool kExclusive = true;

  __device__ __forceinline__ BreaksIo bind(int64_t row) const {
    BreaksIo io = *this;
    io.nlim = __ldg(nb + row) - cap;
    return io;
  }

  // a warp's part of the tile: 32 groups a register group, stride / 2
  __device__ __forceinline__ static bool warp_first(int i, int stride) {
    return i % (stride >> 1) == 0;
  }

  __device__ __forceinline__ void stage(int64_t at, int i, int4* slot,
                                        int stride) const {
    lzs::cp_async16(slot, score + at);
    lzs::cp_async16(slot + stride, off + at);
    if (warp_first(i, stride) && i > 0) {
      int2* const before = k4_before + (threadIdx.x >> 5);
      lzs::cp_async4(&before->x, score + at - 1);
      lzs::cp_async4(&before->y, off + at - 1);
    }
  }

  // the group's scan values and its capped and head bits from its score
  // and off (elements past `count` take `pad`), and the element before
  __device__ __forceinline__ void breaks(int i, int count, int pad,
                                         const int* s, const int* o,
                                         bool prev_c, int prev_o, int* v,
                                         Kept& kept) const {
    unsigned bits = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool ge = s[j] >= cap;
      const bool c = ge & (i + j < nlim) & (j < count);
      const bool head = c & (!prev_c | (o[j] != prev_o));
      const int info = ((i + j) << 13) | (ge ? 0x1000 : 0) |
                       min(max(o[j], 0), 0x7FF);
      v[j] = j >= count ? pad : c & !head ? kBig : info;
      bits |= static_cast<unsigned>(c) << j |
              static_cast<unsigned>(head) << (4 + j);
      prev_c = c;
      prev_o = o[j];
    }
    kept.bits = bits;
  }

  __device__ __forceinline__ void load(int64_t at, int i, bool vec,
                                       int count, int pad, int* v,
                                       Kept& kept, const int4* slot,
                                       int stride) const {
    int s[4], o[4];
    __syncwarp();   // the neighbours waited for their cp.async: visible
    if (vec) {
      const int4 s4 = slot[0], o4 = slot[stride];
      s[0] = s4.x;
      s[1] = s4.y;
      s[2] = s4.z;
      s[3] = s4.w;
      o[0] = o4.x;
      o[1] = o4.y;
      o[2] = o4.z;
      o[3] = o4.w;
      int ps = 0, po = 0;
      if (warp_first(i, stride)) {
        if (i > 0) {
          const int2 before = k4_before[threadIdx.x >> 5];
          ps = before.x;
          po = before.y;
        }
      } else {
        // lane - 1's group, or lane 31's previous one: its element 3
        const int4* before =
            (threadIdx.x & 31) ? slot - 1 : slot - lzs::kChainThreads + 31;
        ps = reinterpret_cast<const int*>(before)[3];
        po = reinterpret_cast<const int*>(before + stride)[3];
      }
      breaks(i, 4, pad, s, o, i > 0 && ps >= cap && i - 1 < nlim, po, v,
             kept);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[j] = j < count ? __ldg(score + at + j) : 0;
        o[j] = j < count ? __ldg(off + at + j) : 0;
      }
      const int ps = i > 0 && count > 0 ? __ldg(score + at - 1) : 0;
      const int po = i > 0 && count > 0 ? __ldg(off + at - 1) : 0;
      breaks(i, count, pad, s, o, i > 0 && ps >= cap && i - 1 < nlim, po,
             v, kept);
    }
  }

  // s: the exclusive suffix min (the next break after each element;
  // INT_MAX past the row's end, where JAX has kBig: both fail < kBig)
  __device__ __forceinline__ void store(int64_t at, int i, bool vec,
                                        int count, const int* s,
                                        const Kept& kept, const int4* slot,
                                        int stride) const {
    int o[4];
    if (vec) {
      const int4 o4 = slot[stride];
      o[0] = o4.x;
      o[1] = o4.y;
      o[2] = o4.z;
      o[3] = o4.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) o[j] = j < count ? __ldg(off + at + j) : 0;
    }
    int r[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const unsigned capped = (kept.bits >> j) & 1;
      const unsigned head = (kept.bits >> (4 + j)) & 1;
      const int nxt1 = s[j];
      const bool has_brk = nxt1 < kBig;
      const int e = has_brk ? nxt1 >> 13 : npos;
      const bool steal =
          has_brk & (((nxt1 >> 12) & 1) == 1) & ((nxt1 & 0x7FF) < o[j]);
      // e + cap >= n
      const bool need_probe = head & ((e >= nlim) | steal);
      const unsigned ext_res = static_cast<unsigned>(e - (i + j) - 1);
      r[j] = static_cast<int>(ext_res << 3 | head << 2 | capped << 1 |
                              static_cast<unsigned>(need_probe));
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
  static constexpr bool kExclusive = false;

  __device__ __forceinline__ FoldIo bind(int64_t) const { return *this; }

  __device__ __forceinline__ void stage(int64_t at, int, int4* slot,
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

}  // namespace

// tile, words, capacity: as the chained row scans take them (rowscan.cu).
LZS_API int lzs_ext_breaks(const int* score, const int* off, const int* nb,
                           int* out, int rows, int npos, int cap, int tile,
                           void* words, int capacity, int device,
                           void* stream) {
  const bool vec = npos % 4 == 0 && lzs::aligned16(score) &&
                   lzs::aligned16(off) && lzs::aligned16(out);
  return lzs::chain_rows<lzs::MinOp, true>(
      BreaksIo{score, off, nb, out, npos, cap}, vec, rows, npos, tile,
      words, capacity, device, stream);
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
