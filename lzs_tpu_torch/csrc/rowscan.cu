// Row scans over (B, N) rows: inclusive prefix max, suffix min and prefix
// sum of int32, and the exclusive count of a bool mask.
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
// Design (one template, instantiated as sum forward (K9), max forward
// (K8), min backward (K7) and the mask's exclusive sum forward (K6)): the
// callers give many rows (the raw decoder's 256 x 33792 slot rows, the
// encoder's 256 x 32768, the filled records' 256 x 38656, the probe's
// 256 x 32768 mask; the raw plain heads' 1024 x 75776 chain rows) and few
// (one 89216-slot row per 2^18 decode_block; four 200704-wide chain rows
// in its plain heads), so a row is
// not a CTA's: every CTA takes one tile of a row, and the tiles chain
// their partial results in one pass (a scan with decoupled look-back). A
// max, a min and a wrapping sum chain alike; each starts from its
// operator's identity (INT_MIN, INT_MAX, 0), which also pads the row's
// ragged end. The kernel is lzs::chain_scan_kernel of chain.cuh (its
// comment has the design). K7-K9 go through CopyIo: each group of 4 is
// read from `in` (one 16-byte load where the row is aligned) and its scan
// written to `out`. K6 goes through RankIo: a group is 4 mask bytes, one
// 4-byte cp.async into shared memory where the row is aligned (a warp
// copies 128 consecutive bytes; the tile's copies are all in flight
// before the first is read), each byte counted as 1 where it is not 0,
// and the store takes the exclusive scan (Io::kExclusive). (K6 walked its row with one CTA
// of 1024 threads before: a tile of 1024 bytes at a time, three barriers
// between one tile's loads and the next's.) K4 and K5 (extend.cu) are
// other policies of the same kernel.
#include "chain.cuh"

namespace {

// Writes a group's 4 outputs at `at` (one 16-byte store where `vec`).
__device__ __forceinline__ void store_group(int* out, int64_t at, bool vec,
                                            int count, const int* s) {
  if (vec) {
    *reinterpret_cast<int4*>(out + at) = make_int4(s[0], s[1], s[2], s[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < count) out[at + j] = s[j];
  }
}

// K7-K9: read `in`, write `out`; nothing kept between load and store.
struct CopyIo {
  const int* in;
  int* out;
  struct Kept {};
  static constexpr int kPlanes = 0;
  static constexpr bool kExclusive = false;

  __device__ __forceinline__ CopyIo bind(int64_t) const { return *this; }

  __device__ __forceinline__ void load(int64_t at, int, bool vec, int count,
                                       int pad, int* v, Kept&, const int4*,
                                       int) const {
    if (vec) {
      const int4 w4 = __ldg(reinterpret_cast<const int4*>(in + at));
      v[0] = w4.x;
      v[1] = w4.y;
      v[2] = w4.z;
      v[3] = w4.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = j < count ? __ldg(in + at + j) : pad;
    }
  }

  __device__ __forceinline__ void store(int64_t at, int, bool vec, int count,
                                        const int* s, const Kept&,
                                        const int4*, int) const {
    store_group(out, at, vec, count, s);
  }
};

template <class Op, bool kReverse>
int chain_rows(const int* in, int* out, int rows, int n, int tile,
               void* words, int capacity, int device, void* stream) {
  const bool vec = n % 4 == 0 && lzs::aligned16(in) && lzs::aligned16(out);
  return lzs::chain_rows<Op, kReverse>(CopyIo{in, out}, vec, rows, n, tile,
                                       words, capacity, device, stream);
}

// K6: counts the set bytes of a bool row (any byte but 0 counts 1) and
// stores each element's exclusive count. A 4-byte-aligned group stages
// its 4 bytes in shared memory (cp.async, plane 0) before any is read: a
// group that loaded its word into registers unpacked it at once, inside
// its branch region, so each group's load waited for the one before
// (PERF.md). A ragged or misaligned group reads device memory alone.
struct RankIo {
  const unsigned char* mask;
  int* out;
  struct Kept {};
  static constexpr int kPlanes = 1;
  static constexpr bool kExclusive = true;

  __device__ __forceinline__ RankIo bind(int64_t) const { return *this; }

  __device__ __forceinline__ void stage(int64_t at, int, int4* slot,
                                        int) const {
    lzs::cp_async4(reinterpret_cast<int*>(slot), mask + at);
  }

  __device__ __forceinline__ void load(int64_t at, int, bool vec, int count,
                                       int pad, int* v, Kept&,
                                       const int4* slot, int) const {
    if (vec) {
      const unsigned w = *reinterpret_cast<const unsigned*>(slot);
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = ((w >> (8 * j)) & 0xFFu) != 0;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[j] = j < count ? __ldg(mask + at + j) != 0 : pad;
    }
  }

  __device__ __forceinline__ void store(int64_t at, int, bool vec, int count,
                                        const int* s, const Kept&,
                                        const int4*, int) const {
    store_group(out, at, vec, count, s);
  }
};

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
                               int n, int tile, void* words, int capacity,
                               int device, void* stream) {
  // a group's 4 bytes are one word where every row starts 4-byte aligned
  const bool vec = n % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(mask) & 3) == 0 &&
                   lzs::aligned16(out);
  return lzs::chain_rows<lzs::AddOp, false>(RankIo{mask, out}, vec, rows, n,
                                            tile, words, capacity, device,
                                            stream);
}

LZS_API const char* lzs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
