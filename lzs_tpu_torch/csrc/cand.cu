// One level of the sort-based match search, over int32 (B, N) rows of
// sorted ranks (N <= 32768), in one launch: for match length k, the keys
// that group the ranks into k-segments, their row sort, and the fold of
// the sorted keys into the packed running best.
//
//   keys  key[j] = (cummax_{j' <= j}(plcp[j'] < k ? j' : 0) << 15) | p[j]:
//         the rank where slot j's k-segment starts, and its position.
//   sort  the row of keys, ascending.
//   fold  slot j's predecessor in the same segment, if it lies within the
//         window, is the nearest earlier occurrence of the k-gram at mypos
//         = key & 0x7FFF; out[mypos] = max(pk[mypos], hit ? k << 16 |
//         32768 - (mypos - cand) : -1).
//
// Replaces: lzs_tpu/ops/pcand.py _keys_kernel (K1), _back_kernel (K2) and
// _acc_kernel (K3), and the two row sorts (lax.sort) that join them. The
// TPU kernels scan by log-step rolls in VMEM and leave both sorts to XLA;
// the second one only puts K2's output back in position order. Here the
// positions of a row's keys are a permutation of 0..N-1 (p holds every
// position, padding included), so the fold stores each slot's result at
// its position, one writer per position, and that sort is not needed.
//
// Bound: memory. A level reads plcp, p and pk and writes out (16 bytes per
// element); the keys, their sort and the position-order results never
// leave shared memory. (The chain this kernel replaced wrote the keys to
// device memory, sorted them there with a library sort at 0.73 ms per
// level at 256 x 32768 on an H100, and read them back.)
//
// Design: one CTA per row; each thread holds 32 keys in registers.
//   - Keys: the CTA loads plcp and p coalesced into a shared row (the
//     compare folded into the store, 1 bit beside the position); each
//     thread then takes 32 consecutive slots, runs its own cummax over
//     them and joins the others' by one block scan (lzs::block_scan).
//   - Sort: a bitonic network over 2^lg slots (lg = max(10, log2 N)
//     rounded up), the slots past N holding 0x7FFFFFFF, above every real
//     key (< 2^30). Bitonic because its steps are fixed: every
//     compare-exchange pairs two registers of one thread, and between
//     steps whose strides lie in different 5-bit groups of the slot index
//     the row moves once through shared memory to the layout that puts
//     those bits in the register index (25 moves for 32768 keys against
//     120 steps). One pad word per 32 keeps each warp's accesses on 32
//     banks in every layout. A sort that exploits the segments
//     (singletons need none) would do less work on some rows but not on a
//     row that is one segment; the network costs the same on both. Runs
//     of up to 16 take their directions from the register index at
//     compile time; a form that tested each pair's direction (bit m of its
//     slot) was slower, and compare-exchanges on the float lanes (the
//     keys' bits as floats) were no faster than int32 min and max and
//     spilled registers.
//   - Fold: the sort ends with each thread holding 32 consecutive sorted
//     slots; slot j - 1 is a register, a shuffle or one shared word away.
//     The row is reset to -1 (no hit), each result goes to its position in
//     it (the keys are in registers by then), and the row is written out
//     coalesced as max(pk, result): a position that no slot holds, which a
//     p that does not permute 0..N-1 leaves, comes out as pk. The output
//     never aliases pk: a caller may keep the accumulator of every level.
// Shared memory: (2^lg + 2^lg / 32) words, 132 KiB at N = 32768, which
// leaves one CTA per SM.
#include "scan.cuh"

namespace {

constexpr int kPer = 32;                // keys per thread
constexpr int kPadKey = 0x7FFFFFFF;     // above every real key
constexpr unsigned kFull = 0xFFFFFFFFu;

// The shared word of slot i: one pad word after every 32.
__device__ __forceinline__ int padded(int i) { return i + (i >> 5); }

// Layout `lo`: thread t holds the slots base + r * 2^lo, r = 0..31, so the
// register index is bits lo..lo+4 of the slot and t the other bits. lo is
// 0 or at least 5: either way a warp's 32 lanes differ in slot bits 0..4
// (lo >= 5) or the pad word spreads them (lo = 0), and slot base + r * 2^lo
// lies at shared word padded(base) + r * step.
__device__ __forceinline__ int layout_base(int t, int lo) {
  return (t & ((1 << lo) - 1)) | ((t >> lo) << (lo + 5));
}

__device__ __forceinline__ int layout_step(int lo) {
  return lo == 0 ? 1 : (1 << lo) + (1 << (lo - 5));
}

// One bitonic step of the merge of runs of 2^M (M < 5) on register
// stride 2^S: registers r and r + 2^S are put in order, descending where
// bit M of r is set.
template <int M, int S>
__device__ __forceinline__ void step_dir(int (&v)[kPer]) {
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    if (r & (1 << S)) continue;
    const int q = r | (1 << S);
    const int lo = min(v[r], v[q]), hi = max(v[r], v[q]);
    const bool desc = (r >> M) & 1;
    v[r] = desc ? hi : lo;
    v[q] = desc ? lo : hi;
  }
}

// One bitonic step on register stride 2^S, ascending.
template <int S>
__device__ __forceinline__ void step_regs(int (&v)[kPer]) {
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    if (r & (1 << S)) continue;
    const int q = r | (1 << S);
    const int a = v[r], b = v[q];
    v[r] = min(a, b);
    v[q] = max(a, b);
  }
}

// Complements every key where `yes` (1 or 0): the order reverses.
__device__ __forceinline__ void flip_if(int (&v)[kPer], int yes) {
  const int mask = -yes;
#pragma unroll
  for (int r = 0; r < kPer; ++r) v[r] ^= mask;
}

// Moves the keys from layout `from` to layout `to` through the shared row.
// Thread t stores to the words that it alone loaded last (in the previous
// move, or as the keys' slots), so no barrier is needed before the stores.
// Layouts 0 and 5 give warp w the same 1024 slots (w's bits 10..14), so a
// move between them needs only the warp's barrier.
__device__ __forceinline__ void relayout(int (&v)[kPer], int* row, int from,
                                         int to) {
  const int t = threadIdx.x;
  int a = padded(layout_base(t, from));
  int step = layout_step(from);
#pragma unroll
  for (int r = 0; r < kPer; ++r) row[a + r * step] = v[r];
  if (from <= 5 && to <= 5) {
    __syncwarp();
  } else {
    __syncthreads();
  }
  a = padded(layout_base(t, to));
  step = layout_step(to);
#pragma unroll
  for (int r = 0; r < kPer; ++r) v[r] = row[a + r * step];
}

// Sorts the 2^lg keys held 32 per thread (2^(lg - 5) threads, lg >= 10)
// ascending, in layout 0 on entry and on return: the bitonic network.
// Merges of runs of 2..16 lie in each thread's registers and take their
// directions from r. From runs of 32 on, a run that its merge sorts
// descending (bit m of its slots set, one bit of t in layout 0) is held
// complemented during the merge, so that every step is ascending: min and
// max, no direction test. The strides 2^(m-1) .. 1 of the merge of runs
// of 2^m run in groups of slot bits top .. lo, one layout each, the last
// group in layout 0.
__device__ __forceinline__ void sort_row(int (&v)[kPer], int* row, int lg) {
  step_dir<1, 0>(v);
  step_dir<2, 1>(v);
  step_dir<2, 0>(v);
  step_dir<3, 2>(v);
  step_dir<3, 1>(v);
  step_dir<3, 0>(v);
  step_dir<4, 3>(v);
  step_dir<4, 2>(v);
  step_dir<4, 1>(v);
  step_dir<4, 0>(v);
  const int t = threadIdx.x;
  flip_if(v, t & 1);                     // bit 5 of the slot 32t + r
  int lo = 0;
  for (int m = 5; m <= lg; ++m) {
    int top = m - 1;
    while (true) {
      const int want = top < 5 ? 0 : min(max(top - 4, 5), lg - 5);
      if (want != lo) {
        relayout(v, row, lo, want);
        lo = want;
      }
      for (int b = top; b >= lo; --b) {
        switch (b - lo) {
          case 4: step_regs<4>(v); break;
          case 3: step_regs<3>(v); break;
          case 2: step_regs<2>(v); break;
          case 1: step_regs<1>(v); break;
          default: step_regs<0>(v); break;
        }
      }
      if (lo == 0) break;
      top = lo - 1;
    }
    // from bit m of the slot to bit m + 1 (bit lg is 0 in every slot)
    if (m < lg) flip_if(v, ((t >> (m - 5)) ^ (t >> (m - 4))) & 1);
  }
}

// Dynamic shared memory: int[2^lg + 2^lg / 32], the row.
__global__ void __launch_bounds__(lzs::kThreads)
perk_level_kernel(const int* __restrict__ plcp, const int* __restrict__ p,
                  const int* __restrict__ nb, const int* __restrict__ pk,
                  int* __restrict__ out, int n, int lg, int k, int window) {
  extern __shared__ int row[];
  __shared__ int warp_tot[32];
  const int t = threadIdx.x;
  const int nt = blockDim.x;
  const int64_t off = static_cast<int64_t>(blockIdx.x) * n;

  // the position of every slot, bit 15 set where plcp < k (-1 past n)
#pragma unroll 8
  for (int c = 0; c < kPer; ++c) {
    const int i = c * nt + t;
    int w = -1;
    if (i < n) w = p[off + i] | (plcp[off + i] < k ? 1 << 15 : 0);
    row[padded(i)] = w;
  }
  __syncthreads();

  // keys of slots 32t .. 32t + 31: the thread's own cummax of the segment
  // heads, then the block's
  int seg[kPer];
  int run = 0;
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const int w = row[padded(kPer * t + r)];
    if (w >= 0 && (w >> 15)) run = kPer * t + r;
    seg[r] = run;
  }
  int excl, total;
  lzs::block_scan(run, lzs::MaxOp{}, warp_tot, &excl, &total);
  int v[kPer];
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const int w = row[padded(kPer * t + r)];
    v[r] = w < 0 ? kPadKey : (max(excl, seg[r]) << 15) | (w & 0x7FFF);
  }

  sort_row(v, row, lg);

  // the fold: slot j's predecessor is slot j - 1
  __shared__ int last[32];
  const int lane = t & 31, warp = t >> 5;
  int before = __shfl_up_sync(kFull, v[kPer - 1], 1);
  if (lane == 31) last[warp] = v[kPer - 1];
  __syncthreads();  // also: every read of the row by the sort is done
  // no hit where no slot holds the position (p not a permutation)
#pragma unroll 8
  for (int c = 0; c < kPer; ++c) {
    const int i = c * nt + t;
    if (i < n) row[i] = -1;
  }
  __syncthreads();
  if (lane == 0) before = warp > 0 ? last[warp - 1] : -1;
  const int limit = nb[blockIdx.x];
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const int key = v[r];
    const int prev = r > 0 ? v[r - 1] : before;
    const int mypos = key & 0x7FFF;
    const int prevpos = prev & 0x7FFF;
    const bool same = (key >> 15) == (prev >> 15);
    const int cand = same && mypos - prevpos <= window ? prevpos : -1;
    const bool hit = cand >= 0 && mypos + k <= limit;
    const int val = hit ? (k << 16) | (32768 - (mypos - cand)) : -1;
    // slots past n hold the pad keys
    if (kPer * t + r < n && mypos < n) row[mypos] = val;
  }
  __syncthreads();
#pragma unroll 8
  for (int c = 0; c < kPer; ++c) {
    const int i = c * nt + t;
    if (i < n) out[off + i] = max(pk[off + i], row[i]);
  }
}

}  // namespace

LZS_API int lzs_perk_level(const int* plcp, const int* p, const int* nb,
                           const int* pk, int* out, int rows, int n, int k,
                           int window, int device, void* stream) {
  const lzs::DeviceGuard guard(device);
  int lg = 10;
  while ((1 << lg) < n) ++lg;
  const int slots = 1 << lg;
  const size_t smem = static_cast<size_t>(slots + slots / 32) * sizeof(int);
  const cudaError_t err = cudaFuncSetAttribute(
      perk_level_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  perk_level_kernel<<<rows, slots / kPer, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      plcp, p, nb, pk, out, n, lg, k, window);
  return static_cast<int>(cudaGetLastError());
}
