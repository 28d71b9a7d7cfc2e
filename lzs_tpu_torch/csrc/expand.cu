// LZ77 copy expansion: filled parse records -> decoded bytes + status.
//
// Replaces: lzs_tpu/ops/pexpand.py _expand_rec_kernel (K17: a carried
// slot pointer and a 768-slot record window per chunk, a binary search of
// each byte's covering record in that window, a carried 2 KiB circular
// byte window with two-level gathers, 6 in-chunk doubling rounds, status
// bits 0-1).
//
// Bound: bytes (the record row is read once, one byte is written per
// output byte), but the work is a walk of dependent chunks: a copy's
// source may be a byte of the same chunk that is not resolved yet, so
// each chunk waits for the one before it.
//
// Design: one CTA of 1024 threads per block row (two per SM) walks the
// row in chunks of kT = 1024 bytes, one byte per thread:
//   * records: the row's slots stream through a ring of kRing tiles of kT
//     slots in shared memory, loaded with cp.async kRing tiles ahead of
//     the TPU kernel's carried slot pointer (the cursor), so the next
//     chunk's records arrive while this chunk resolves. Records are
//     nondecreasing and so are their output positions: a chunk consumes
//     the slots from the cursor on whose output position lies before the
//     next chunk (as many tiles as that takes: a chunk's records are never
//     cut off), and each of them that ends a run of equal output positions
//     writes its record at that position in a chunk-wide shared array
//     (atomicMax: a run cut by a tile's end has two writers). A block
//     max-scan of that array, joined with the carry of earlier chunks,
//     gives every byte its covering record: the last record whose output
//     position is <= the byte. Once a consumed tile ends on the row's last
//     record, the rest of the row (its padding, which repeats that record)
//     is not read;
//   * a literal gives its byte; a copy of offset d starting at s reads
//     s - d + (j - s) mod d (a division only past the copy's first d
//     bytes), which is strictly before s: a source before
//     the chunk is final, a source before the block start is 0 (status
//     bit 1). The decoded row sits in shared memory where it fits (32 KiB
//     at block 32768; up to the card's opt-in limit less the chunk's
//     arrays); a wider row (the raw decoder allows 2^18 bytes) is read
//     back from the output row in device memory, which the same CTA wrote
//     in earlier chunks (__syncthreads() makes those writes visible);
//   * sources inside the chunk resolve by pointer jumping over one packed
//     word per byte (pointer << 9 | resolved << 8 | byte), ping-ponged
//     between two arrays so that a round takes one barrier; chains point
//     strictly backwards, so log2(kT) + 1 rounds resolve every byte.
// Status bit 0 marks a byte in [0, n) with no covering record; such a
// byte also sets bit 1, as in the TPU kernel.
#include "scan.cuh"

namespace {

constexpr int kT = lzs::kThreads;     // bytes per chunk, one per thread
constexpr int kRing = 8;              // record tiles of kT slots in flight
constexpr int kResolved = 1 << 8;

__device__ __forceinline__ void cp_async4(int* smem, const int* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Starts the copy of record tile t (slots t*kT .. of the row) into its
// ring buffer; one commit group per tile, empty past the row.
__device__ __forceinline__ void load_tile(int* ring, const int* rrow, int s,
                                          int t) {
  const int i = t * kT + threadIdx.x;
  if (i < s) cp_async4(ring + (t & (kRing - 1)) * kT + threadIdx.x, rrow + i);
  cp_async_commit();
}

// Inclusive max-scan of one value per thread, one barrier: every warp
// scans the 32 warp totals itself. Two calls must be separated by another
// barrier (warp_tot is rewritten).
__device__ __forceinline__ int block_max_scan(int v, int* warp_tot,
                                              int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v = max(v, u);
  }
  if (lane == 31) warp_tot[warp] = v;
  __syncthreads();
  int t = warp_tot[lane];
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, t, d);
    if (lane >= d) t = max(t, u);
  }
  const int before = __shfl_sync(0xffffffffu, t, (warp + 31) & 31);
  *total = __shfl_sync(0xffffffffu, t, 31);
  return warp > 0 ? max(before, v) : v;
}

__global__ void __launch_bounds__(kT, 2)
expand_kernel(const int* __restrict__ recfill, const int* __restrict__ n,
              int s, uint8_t* __restrict__ out, int out_cap,
              int* __restrict__ status, bool row_in_smem) {
  extern __shared__ int smem[];
  __shared__ int warp_tot[32];
  int* ring = smem;                     // kRing tiles of kT records
  int* cov = ring + kRing * kT;         // record at each chunk position
  int* cell = cov + kT;                 // two arrays of packed bytes
  unsigned char* obuf = reinterpret_cast<unsigned char*>(cell + 2 * kT);
  const int tid = threadIdx.x;
  const int64_t row = blockIdx.x;
  const int* rrow = recfill + row * s;
  uint8_t* orow = out + row * out_cap;
  const int nb = n[row];
  const int last_rec = __ldg(rrow + s - 1);   // the row's largest record

  for (int t = 0; t < kRing; ++t) load_tile(ring, rrow, s, t);
  int tile = 0;          // ring tile holding the cursor
  int cursor = 0;        // first slot not consumed by an earlier chunk
  bool rest_read = false;
  int carry = -1;        // covering record of the byte before the chunk
  int bad = 0;

  for (int base = 0; base < out_cap; base += kT) {
    const int next_base = base + kT;
    cov[tid] = -1;
    while (!rest_read) {
      cp_async_wait<kRing - 1>();
      __syncthreads();   // this tile has landed for every thread
      const int* buf = ring + (tile & (kRing - 1)) * kT;
      const int i = tile * kT + tid;
      bool used = false;
      if (i >= cursor && i < s) {
        const int r = buf[tid];
        const int o = r >= 0 ? r >> 13 : -1;
        used = o < next_base;
        if (used && o >= base &&
            (tid == kT - 1 || i == s - 1 || (buf[tid + 1] >> 13) != o))
          atomicMax(cov + (o - base), r);
      }
      const int tile_last = buf[kT - 1];
      cursor += __syncthreads_count(used);
      const int tile_end = min((tile + 1) * kT, s);
      if (cursor < tile_end) break;   // the next chunk starts in this tile
      if (tile_end == s || tile_last == last_rec) {
        rest_read = true;             // the rest repeats the last record
      } else {
        load_tile(ring, rrow, s, tile + kRing);
        ++tile;
      }
    }

    int total;
    const int rec = max(carry, block_max_scan(cov[tid], warp_tot, &total));
    carry = max(carry, total);

    const int j = base + tid;
    int c = kResolved;                 // resolved, byte 0
    if (j < out_cap) {
      if (rec < 0) {
        if (j < nb) bad |= 3;   // the TPU kernel's -1 record is also a
                                // copy from before the block start
      } else if (((rec >> 11) & 1) == 0) {
        c = kResolved | (rec & 0xFF);
      } else {
        const int seg = rec >> 13;
        const int d = max(rec & 0x7FF, 1);
        const int k = j - seg;
        const int src = seg - d + (k < d ? k : k % d);
        if (src < 0) {
          if (j < nb) bad |= 2;
        } else if (src < base) {
          c = kResolved | (row_in_smem ? obuf[src] : __ldcg(orow + src));
        } else {
          c = (src - base) << 9;
        }
      }
    }
    int* from = cell;
    int* to = cell + kT;
    from[tid] = c;
    while (__syncthreads_or(!(c & kResolved))) {
      if (!(c & kResolved)) c = from[c >> 9];
      to[tid] = c;
      int* swap = from;
      from = to;
      to = swap;
    }
    if (j < out_cap) {
      const unsigned char v = static_cast<unsigned char>(c & 0xFF);
      if (row_in_smem) obuf[j] = v;
      orow[j] = j < nb ? v : 0;
    }
  }
  cp_async_wait_all();
  const int b0 = __syncthreads_or(bad & 1);
  const int b1 = __syncthreads_or(bad & 2);
  if (tid == 0) status[row] = (b0 ? 1 : 0) | (b1 ? 2 : 0);
}

}  // namespace

LZS_API int lzs_expand_rows(const int* recfill, const int* n, int rows, int s,
                            uint8_t* out, int out_cap, int* status,
                            int device, void* stream) {
  const lzs::DeviceGuard guard(device);
  int optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  cudaFuncAttributes fa;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, expand_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  // dynamic shared memory: the ring, cov and the two cell arrays, then
  // the decoded row where it fits beside them and the static warp_tot
  const size_t limit = static_cast<size_t>(optin) - fa.sharedSizeBytes;
  const size_t chunk_smem = (kRing + 3) * kT * sizeof(int);
  const bool row_in_smem = chunk_smem + static_cast<size_t>(out_cap) <= limit;
  const size_t smem = chunk_smem + (row_in_smem ? out_cap : 0);
  err = cudaFuncSetAttribute(expand_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  expand_kernel<<<rows, kT, smem, static_cast<cudaStream_t>(stream)>>>(
      recfill, n, s, out, out_cap, status, row_in_smem);
  return static_cast<int>(cudaGetLastError());
}
