// Bit-serial parse of raw LZS streams (the raw decoder's engine "scan"):
// comp bytes -> one packed record per parse step, in one of two layouts
// (one kernel template, two store policies):
//
//   recs[b, t]   (StepMajor, JAX's layout, decode._parse_scan) step t's
//                record: opos << 13 | is_copy << 11 | payload (a literal's
//                byte, a copy's offset), or -1 where the step has no
//                output (an end marker, a zero extension nibble, a step
//                after the stream is done)
//   fill[b, t]   (Filled, decode._parse_scan_filled) the running max of
//                recs[b, 0..t], -1 before the first record, and the last
//                record through the rest of the row, whose width is
//                decode2._flat_width(max_units): the record fill of JAX's
//                decode (_filled_records), which the expansion (K17)
//                reads as it is
//   out_len[b]   the stream's output count after its last step
//   markers[b]   the end markers it read
//
// Replaces: lzs_tpu/ops/decode.py _parse_scan, a lax.scan of max_units
// steps per stream (no Pallas kernel: XLA runs the scan on the TPU as one
// loop, the streams side by side under vmap), and, in the filled form,
// the record fill after it. The state machine is the reference's
// (lzs-decompression.c:459-743) collapsed to two modes (normal, extended)
// and a done flag, with the single-call decoder's per-field input gates
// (lzs-decompression.c:214-343): a literal or an end marker needs 9 bits,
// a short-offset copy head 9 + its length field (2 or 4 bits), a
// long-offset one 13 + its length field, an extension nibble 4; a step
// with fewer bits left than its unit needs stops the stream. A copy head
// whose length code is 15 enters extended mode, where each nibble adds
// its value and a nibble of 15 stays there. An end marker consumes up to
// the next byte boundary and stops the stream unless multi_stream.
// Lengths are cut to out_cap - out_count, and the stream stops once its
// output reaches out_cap (so a stream of exactly out_cap bytes reads no
// end marker). Arithmetic is JAX's: int32 (inbytes * 8 wraps).
//
// Bound: latency. Each stream is one chain of dependent steps: a step's
// bit position is the last one's plus its unit's width, which the bits at
// that position decide. The least time is the longest stream's steps
// times one step's chain: the window's funnel shift, the head's field
// tests, the width's selects, the add and the window's advance. The bytes
// are few (C read once, 4 bytes a record slot written).
//
// Design: one CTA of seven warps per stream, a role per warp, so that
// only the chain is serial:
//   * Warp 5 copies the row into a ring of 8 slots of 4 KiB in shared
//     memory, each under a full and an empty mbarrier (K12's design,
//     walk.cu): cp.async of 16 bytes from 16-byte aligned addresses, byte
//     loads for the partial blocks at the row's head and tail, zeros past
//     C (JAX reads its 4 appended zero bytes there) until the walker
//     leaves; each lane then turns its blocks into big-endian words in
//     place, so that the walker's loads feed its window as they are. The
//     ring holds the row from its 16-byte aligned base, so every read
//     stays inside the row.
//   * Lane 0 of warp 0, the walker, follows the bit-position chain on the
//     ring and never waits on device memory: a window of two big-endian
//     words and the next two, each loaded a step before the window can
//     reach it, one funnel shift per step and no branch in a step. A
//     step computes only what the next bit position needs: the unit's
//     width (the head's flag, offset form and the top two bits of its
//     length code; the marker's byte alignment; 4 in extended mode) and
//     the mode (a length code of 15 enters extended mode, a nibble of 15
//     stays there); its stop test (the input gate, a final end marker)
//     is one predicate that it reads after each group of 8 steps. It
//     stores each step's 32-bit window, its mode in bit 0 (which no field
//     reads), and the input bits left before it, in a ring of 4 chunks of
//     512 steps. As it enters byte chunk k it releases chunk k - 2, which
//     the window has passed, so the copy warp runs up to 6 chunks ahead.
//   * Warps 1, 2, 3 and 6, the consumers (128 threads, 4 consecutive steps
//     a thread), take a chunk at a time: each step's fields and gate from
//     its window; a scan over the 128 threads of the last copy head (the
//     extension nibbles' offset) and of the first step that stops; a scan
//     of the lengths, which gives each step's output count, hence JAX's
//     clamp and the stop at out_cap; for the fill, a scan of the records'
//     maxima, carried from chunk to chunk. The records go out in 16-byte
//     stores. The consumers tell the walker when the output is full (it
//     may have walked up to two chunks past that stop, and up to 7 steps
//     past any other stop and past max_units: those steps are no steps),
//     and write the row's tail after the stream (-1, or the last record),
//     so no launch fills the row first.
// Warp 4 leaves at once, so the walker has its SM sub-partition (warp id
// mod 4) to itself: with the copy warp there it took 1-2% more cycles a
// step.
//
// With `stats` (int64[B, 2]) the walker also writes its clock64 cycles
// from its first step to its last and its step count. lzs_chain_latency,
// a launch of one thread, times a chain of kProbeOps dependent funnel
// shifts and adds, the latency of one link of the walker's chain.
#include "async.cuh"
#include "scan.cuh"

namespace {

constexpr int kWarps = 7;
constexpr int kScanThreads = 32 * kWarps;
constexpr int kCopyWarp = 5;
constexpr int kConsumers = 128;              // warps 1, 2, 3, 6
constexpr int kPer = 4;                      // steps per consumer thread
constexpr int kChunk = kConsumers * kPer;    // steps per step-ring slot
constexpr int kStepSlots = 4;
constexpr int kSlotBytes = 4096;
constexpr int kByteSlots = 8;
constexpr int kSlotWords = kSlotBytes / 4;
constexpr uint32_t kRingWords = kByteSlots * kSlotWords;
// Walker steps between branches. A group reads words up to wi + kEarly
// (wi the window's top word at its start): each step moves the window
// on by at most one word and loads the word 3 past it.
constexpr int kGroup = 8;
constexpr uint32_t kEarly = kGroup + 3;
constexpr int kConsumerBarrier = 1;          // named barrier of the consumers
constexpr int kProbeOps = 2 * 16 * 64;       // the latency probe's chain
constexpr size_t kSmemBytes =
    static_cast<size_t>(kByteSlots) * kSlotBytes +
    static_cast<size_t>(kStepSlots) * kChunk * sizeof(int2);

struct Shared {
  uint64_t byte_full[kByteSlots];
  uint64_t byte_empty[kByteSlots];
  uint64_t step_full[kStepSlots];
  uint64_t step_empty[kStepSlots];
  int step_n[kStepSlots];       // steps the walker wrote in the chunk
  int step_last[kStepSlots];    // the walker's last chunk
  int walker_done;              // the walker has left: the copy stops
  int out_full;                 // the consumers found the output full
  int scan_sum[kConsumers / 32];
  int scan_max[kConsumers / 32];
  int scan_min[kConsumers / 32];
  int marks;
};

__device__ __forceinline__ int volatile_load(const int* p) {
  return *static_cast<const volatile int*>(p);
}

__device__ __forceinline__ void volatile_store(int* p, int v) {
  *static_cast<volatile int*>(p) = v;
}

// The ring's stream is the row from its 16-byte aligned base `row - m`:
// its byte j is row byte j - m (zero outside 0 .. c - 1). The chunks of
// 4 KiB that hold row bytes:
__device__ __forceinline__ int64_t byte_chunks(int64_t c, int m) {
  return (c + m + kSlotBytes - 1) / kSlotBytes;
}

// Warp kCopyWarp: chunk k of the ring's stream into slot k % kByteSlots,
// once the walker has released the slot's chunk k - kByteSlots; chunks
// past the row are zeros, and the copy goes on until the walker leaves.
// The ring holds big-endian words: each lane turns the blocks it copied
// in place once its copies have landed.
__device__ void copy_row(const uint8_t* row, int64_t c, int m,
                         uint8_t* ring, Shared& s) {
  const int lane = threadIdx.x & 31;
  const uint8_t* base = row - m;             // 16-byte aligned
  const int64_t nch = byte_chunks(c, m);
  for (int64_t k = 0;; ++k) {
    const int slot = static_cast<int>(k % kByteSlots);
    if (k >= kByteSlots) {
      const unsigned parity = static_cast<unsigned>(k / kByteSlots - 1) & 1;
      bool left = false;
      while (!lzs::mbar_try_wait(&s.byte_empty[slot], parity)) {
        if (volatile_load(&s.walker_done)) {
          left = true;
          break;
        }
      }
      if (left) break;
    } else if (volatile_load(&s.walker_done)) {
      break;
    }
    uint8_t* dst = ring + slot * kSlotBytes;
    const int64_t e0 = k * kSlotBytes;
    auto whole = [&](int q) {                // a block inside the row
      const int64_t j = e0 + 16 * q;         // ring stream byte of the block
      return j >= m && j + 16 <= c + m;
    };
    for (int q = lane; q < kSlotBytes / 16; q += 32) {
      if (whole(q)) {
        lzs::cp_async16(dst + 16 * q, base + e0 + 16 * q);
      } else {
        uint32_t v[4] = {0, 0, 0, 0};
        if (k < nch) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
#pragma unroll
            for (int z = 0; z < 4; ++z) {
              const int64_t p = e0 + 16 * q + 4 * i + z - m;
              if (p >= 0 && p < c)
                v[i] |= static_cast<uint32_t>(__ldg(row + p))
                        << (24 - 8 * z);
            }
          }
        }
        *reinterpret_cast<uint4*>(dst + 16 * q) =
            make_uint4(v[0], v[1], v[2], v[3]);
      }
    }
    lzs::cp_async_wait_all();
    for (int q = lane; q < kSlotBytes / 16; q += 32) {
      if (whole(q)) {
        uint4* b = reinterpret_cast<uint4*>(dst + 16 * q);
        const uint4 x = *b;
        *b = make_uint4(
            __byte_perm(x.x, 0, 0x0123), __byte_perm(x.y, 0, 0x0123),
            __byte_perm(x.z, 0, 0x0123), __byte_perm(x.w, 0, 0x0123));
      }
    }
    lzs::mbar_arrive(&s.byte_full[slot]);
  }
}

// Word j of the ring's stream (big-endian already).
__device__ __forceinline__ uint32_t ring_word(const uint32_t* ring,
                                              uint32_t j) {
  return ring[j & (kRingWords - 1)];
}

// The bits a normal-mode unit needs, from the window w at its position
// (a literal or an end marker 9, a short-offset copy head 11 or 13, a
// long-offset one 15 or 17).
__device__ __forceinline__ int head_need(uint32_t w) {
  const bool lit = static_cast<int>(w) >= 0;
  const bool marker = (w & 0xFF800000u) == 0xC0000000u;
  const int ws = (w & 0x00600000u) == 0x00600000u ? 13 : 11;
  const int wl = (w & 0x00060000u) == 0x00060000u ? 17 : 15;
  const int copy = (w & 0x40000000u) != 0 ? ws : wl;
  return lit || marker ? 9 : copy;
}

// Lane 0 of warp 0: the bit-position chain of one stream. Each step
// stores its window with its mode in bit 0 (no field reads bit 0) and
// the input bits left before it; the consumers decide from these where
// the stream stops. The walker stops after the group of kGroup steps in
// which a step lacks its bits, reads a final end marker, or reaches
// max_units, or at a chunk's end once the consumers found the output
// full.
__device__ void walk(const uint32_t* ring, int2* steps, Shared& s, int m,
                     int inbits, int max_units, bool multi,
                     long long* stats) {
  int64_t next_chunk = 0;          // the byte chunk the walker waits for next
  uint32_t ready = 0;              // words below it are in the ring
  auto enter = [&]() {
    // the window lies in chunk next_chunk - 1 (within kEarly words of its
    // end), so chunk next_chunk - 2 is behind it: its slot goes back to the
    // copy warp, which waits for it before chunk next_chunk + 6
    if (next_chunk >= 2)
      lzs::mbar_arrive(&s.byte_empty[(next_chunk - 2) % kByteSlots]);
    lzs::mbar_wait(&s.byte_full[next_chunk % kByteSlots],
                   static_cast<unsigned>(next_chunk / kByteSlots) & 1);
    ++next_chunk;
    ready = static_cast<uint32_t>(next_chunk * kSlotWords);
  };

  // the window: words wi (hi) and wi + 1 (lo) of the ring's stream, its
  // bit position sh within hi; nx is word wi + 2
  uint32_t wi = static_cast<uint32_t>(m >> 2);
  int sh = 8 * (m & 3);
  enter();
  uint32_t hi = ring_word(ring, wi);
  uint32_t lo = ring_word(ring, wi + 1);
  uint32_t nx = ring_word(ring, wi + 2);
  int rem = inbits;                // inbits - bitpos, int32 that wraps
  uint32_t mode = 0;
  const bool final_marker = !multi;
  bool stop = max_units <= 0;
  int t0 = 0;                      // steps before this chunk
  const long long start = clock64();
  for (int chunk = 0;; ++chunk) {
    const int slot = chunk % kStepSlots;
    if (chunk >= kStepSlots)
      lzs::mbar_wait(&s.step_empty[slot],
                     static_cast<unsigned>(chunk / kStepSlots - 1) & 1);
    int2* e = steps + slot * kChunk;
    int n = 0;
    while (!stop && n < kChunk) {
      if (wi + kEarly >= ready) enter();
      int2* g = e + n;
#pragma unroll
      for (int k = 0; k < kGroup; ++k) {
        // the word after nx, loaded now and taken at the step's end if
        // the window moves on: its load is off the chain
        const uint32_t ahead = ring_word(ring, wi + 3);
        const uint32_t w = __funnelshift_l(lo, hi, sh);
        const bool ext = mode != 0;
        const bool lit = static_cast<int>(w) >= 0;
        const bool shrt = (w & 0x40000000u) != 0;
        const bool marker = (w & 0xFF800000u) == 0xC0000000u;
        // the width: the special units' (4, a marker's alignment, 9)
        // beside the copy heads', one select between them
        const int ws = (w & 0x00600000u) == 0x00600000u ? 13 : 11;
        const int wl = (w & 0x00060000u) == 0x00060000u ? 17 : 15;
        const int copy_width = shrt ? ws : wl;
        const int special = ext ? 4 : marker ? ((sh + 16) & ~7) - sh : 9;
        const bool copy_head = !(ext | lit | marker);
        const int width = copy_head ? copy_width : special;
        const int need = copy_head ? copy_width : ext ? 4 : 9;
        stop = stop | (rem < need) | (marker & !ext & final_marker);
        // a copy head whose length code is 15 enters extended mode, a
        // nibble of 15 stays there
        const uint32_t v = shrt ? w >> 4 : w;
        const bool l15 = (v & 0x00078000u) == 0x00078000u;
        g[k] = make_int2(static_cast<int>((w & ~1u) | mode), rem);
        mode = ext ? static_cast<uint32_t>(w >= 0xF0000000u)
                   : static_cast<uint32_t>(copy_head & l15);
        rem = static_cast<int>(static_cast<unsigned>(rem) - width);
        const int s2 = sh + width;
        const bool adv = s2 >= 32;
        sh = s2 & 31;
        hi = adv ? lo : hi;
        lo = adv ? nx : lo;
        nx = adv ? ahead : nx;
        wi += adv;
      }
      n += kGroup;
      stop = stop | (t0 + n >= max_units);
    }
    const bool last = stop || volatile_load(&s.out_full);
    s.step_n[slot] = n;
    s.step_last[slot] = last;
    lzs::mbar_arrive(&s.step_full[slot]);
    t0 += n;
    if (last) break;
  }
  if (stats != nullptr) {
    stats[2 * blockIdx.x] = clock64() - start;
    stats[2 * blockIdx.x + 1] = t0;
  }
  volatile_store(&s.walker_done, 1);
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync %0, %1;\n" ::"n"(kConsumerBarrier),
               "n"(kConsumers)
               : "memory");
}

// One value of each kind per consumer, scanned over the consumers in
// thread order: `sum` and `mx` become their exclusive prefixes (a sum, a
// max) and `*_total` their totals; `mn` becomes the min over all.
struct Scan {
  int sum = 0;
  int mx = INT_MIN;
  int mn = INT_MAX;
  int sum_total = 0;
  int mx_total = INT_MIN;
};

template <bool kSum, bool kMax, bool kMin>
__device__ __forceinline__ void consumer_scan(int ct, Shared& s, Scan& v) {
  const int lane = ct & 31;
  const int warp = ct >> 5;
  int is = v.sum, im = v.mx, mn = v.mn;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int us = kSum ? __shfl_up_sync(0xffffffffu, is, d) : 0;
    const int um = kMax ? __shfl_up_sync(0xffffffffu, im, d) : INT_MIN;
    if (lane >= d) {
      is += us;
      im = max(im, um);
    }
    if (kMin) mn = min(mn, __shfl_xor_sync(0xffffffffu, mn, d));
  }
  int em = kMax ? __shfl_up_sync(0xffffffffu, im, 1) : INT_MIN;
  if (lane == 0) em = INT_MIN;
  if (lane == 31) {
    s.scan_sum[warp] = is;
    s.scan_max[warp] = im;
    s.scan_min[warp] = mn;
  }
  consumer_sync();
  int bs = 0, bm = INT_MIN;
  v.sum_total = 0;
  v.mx_total = INT_MIN;
  v.mn = INT_MAX;
#pragma unroll
  for (int q = 0; q < kConsumers / 32; ++q) {
    const int qs = kSum ? s.scan_sum[q] : 0;
    const int qm = kMax ? s.scan_max[q] : INT_MIN;
    if (q < warp) {
      bs += qs;
      bm = max(bm, qm);
    }
    v.sum_total += qs;
    v.mx_total = max(v.mx_total, qm);
    if (kMin) v.mn = min(v.mn, s.scan_min[q]);
  }
  consumer_sync();                 // the totals are rewritten next time
  v.sum = bs + is - v.sum;
  v.mx = max(bm, em);
}

// A step's record fields from its window w (its mode in bit 0): length
// (before the clamp), payload (an extension nibble's is the current
// match offset, filled in by the caller), whether it is a copy, an end
// marker, a copy head.
__device__ __forceinline__ void decode_step(uint32_t w, int& len, int& pay,
                                            bool& copy, bool& marker,
                                            bool& head) {
  marker = false;
  head = false;
  if (w & 1u) {                    // EXTENDED: one length nibble
    len = static_cast<int>(w >> 28);
    pay = 0;
    copy = true;
  } else if (static_cast<int>(w) >= 0) {   // a literal
    len = 1;
    pay = static_cast<int>((w >> 23) & 0xFF);
    copy = false;
  } else if ((w & 0xFF800000u) == 0xC0000000u) {
    len = 0;
    pay = 0;
    copy = false;
    marker = true;
  } else {                         // a copy head, short offset moved down
    const bool shrt = (w & 0x40000000u) != 0;
    const uint32_t v = shrt ? w >> 4 : w;
    pay = static_cast<int>((v >> 19) & (shrt ? 0x7Fu : 0x7FFu));
    const int l4 = static_cast<int>((v >> 15) & 0xF);
    len = l4 >= 12 ? (l4 & 3) + 5 : (l4 >> 2) + 2;
    copy = true;
    head = true;
  }
}

// Four values at row[t .. t + 3], those at or past lim dropped; one
// 16-byte store where `vec` (row 16-byte aligned, t % 4 == 0) and all
// four lie before lim.
__device__ __forceinline__ void put4(int* row, int64_t t, const int* v,
                                     int64_t lim, bool vec) {
  if (vec && t + 3 < lim) {
    *reinterpret_cast<int4*>(row + t) = make_int4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (t + k < lim) row[t + k] = v[k];
  }
}

// JAX's layout: recs[b, t], rows of max_units.
struct StepMajor {
  static constexpr bool kFilled = false;
  int* recs;
  bool vec;                        // 16-byte aligned rows
  __device__ int* row(int64_t b, int max_units) const {
    return recs + b * max_units;
  }
  __device__ int64_t width(int max_units) const { return max_units; }
};

// The fill's rows of `w` (a multiple of 4, at least max_units, 16-byte
// aligned).
struct Filled {
  static constexpr bool kFilled = true;
  int* fill;
  int w;
  bool vec = true;
  __device__ int* row(int64_t b, int) const { return fill + b * w; }
  __device__ int64_t width(int) const { return w; }
};

template <class Store>
__device__ void consume(const int2* steps, Shared& s, int ct, int out_cap,
                        int max_units, bool multi, const Store& store,
                        int* __restrict__ out_len,
                        int* __restrict__ markers) {
  int* const row = store.row(blockIdx.x, max_units);
  const bool vec = store.vec;
  int count = 0;                   // output count before the chunk
  int carry = -1;                  // the fill's running max before it
  int cur_off = 0;                 // the match offset before it
  int marks = 0;
  bool done = false;
  int64_t written = 0;             // the row is written below this step
  for (int chunk = 0;; ++chunk) {
    const int slot = chunk % kStepSlots;
    lzs::mbar_wait(&s.step_full[slot],
                   static_cast<unsigned>(chunk / kStepSlots) & 1);
    const int n = s.step_n[slot];
    const bool last = s.step_last[slot] != 0;
    if (!done) {
      const int64_t t0 = static_cast<int64_t>(chunk) * kChunk;
      // steps at or past lim are not steps: the walker's group ran on
      const int lim = static_cast<int>(
          min(static_cast<int64_t>(n), max_units - t0));
      const int4* q = reinterpret_cast<const int4*>(steps + slot * kChunk +
                                                    ct * kPer);
      const int4 a = q[0], bq = q[1];
      const uint32_t w[kPer] = {static_cast<uint32_t>(a.x),
                                static_cast<uint32_t>(a.z),
                                static_cast<uint32_t>(bq.x),
                                static_cast<uint32_t>(bq.z)};
      const int rem[kPer] = {a.y, a.w, bq.y, bq.w};
      int len[kPer], pay[kPer];
      bool copy[kPer], mk[kPer], head[kPer];
      Scan first;                  // the last copy head, the first stop
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int idx = ct * kPer + k;
        decode_step(w[k], len[k], pay[k], copy[k], mk[k], head[k]);
        const int need = w[k] & 1u ? 4 : head_need(w[k]);
        const int stop = idx >= lim || rem[k] < need ? idx
                         : mk[k] && !multi              ? idx + 1
                                                        : INT_MAX;
        first.mn = min(first.mn, stop);
        if (head[k]) first.mx = idx << 11 | pay[k];
      }
      consumer_scan<false, true, true>(ct, s, first);
      const int dead = first.mn;   // the chunk's steps from here are none
      int off = first.mx >= 0 ? first.mx & 0x7FF : cur_off;
      Scan counts;
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        if (head[k]) off = pay[k];
        if (w[k] & 1u) pay[k] = off;
        if (ct * kPer + k >= dead) {
          len[k] = 0;
          mk[k] = false;
        }
        counts.sum += len[k];
      }
      consumer_scan<true, false, false>(ct, s, counts);
      int at = count + counts.sum;   // output count before the step
      int recs[kPer];
      int top = -1;
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const bool alive = ct * kPer + k < dead && at < out_cap;
        const int l = min(len[k], out_cap - at);
        recs[k] = alive && l > 0
                      ? static_cast<int>(static_cast<unsigned>(at) << 13 |
                                         (copy[k] ? 1u << 11 : 0u) |
                                         static_cast<unsigned>(pay[k]))
                      : -1;
        marks += alive && mk[k];
        top = max(top, recs[k]);
        at += len[k];
      }
      if (Store::kFilled) {
        Scan fill;
        fill.mx = top;
        consumer_scan<false, true, false>(ct, s, fill);
        int run = max(carry, fill.mx);
#pragma unroll
        for (int k = 0; k < kPer; ++k) {
          run = max(run, recs[k]);
          recs[k] = run;
        }
        carry = max(carry, fill.mx_total);
      }
      put4(row, t0 + ct * kPer, recs, max_units, vec);
      count += counts.sum_total;
      if (first.mx_total >= 0) cur_off = first.mx_total & 0x7FF;
      written = min(t0 + kChunk, static_cast<int64_t>(max_units));
      if (count >= out_cap || dead != INT_MAX) {
        done = true;
        if (ct == 0) volatile_store(&s.out_full, 1);
      }
    }
    __syncwarp();
    if ((threadIdx.x & 31) == 0) lzs::mbar_arrive(&s.step_empty[slot]);
    if (last) break;
  }

  // the rest of the row: -1, or the fill's last record
  const int v = Store::kFilled ? carry : -1;
  const int vals[kPer] = {v, v, v, v};
  const int64_t lim = store.width(max_units);
  int64_t from = written;
  const int head = static_cast<int>((4 - (from & 3)) & 3);
  if (ct < head && from + ct < lim) row[from + ct] = v;
  from += head;
  for (int64_t t = from + ct * kPer; t < lim; t += kChunk)
    put4(row, t, vals, lim, vec);

  atomicAdd(&s.marks, marks);
  consumer_sync();
  if (ct == 0) {
    out_len[blockIdx.x] = min(count, out_cap);
    markers[blockIdx.x] = s.marks;
  }
}

template <class Store>
__global__ void __launch_bounds__(kScanThreads)
scan_parse_kernel(const uint8_t* __restrict__ comp, int64_t c,
                  const int* __restrict__ inbytes, int max_units,
                  int out_cap, bool multi_stream, Store store,
                  int* __restrict__ out_len, int* __restrict__ markers,
                  long long* __restrict__ stats) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Shared s;
  const int64_t b = blockIdx.x;
  const uint8_t* row = comp + b * c;
  const int m = static_cast<int>(reinterpret_cast<uintptr_t>(row) & 15);
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kByteSlots; ++i) {
      lzs::mbar_init(&s.byte_full[i], 32);   // the copy warp's lanes
      lzs::mbar_init(&s.byte_empty[i], 1);   // the walker's release
    }
    for (int i = 0; i < kStepSlots; ++i) {
      lzs::mbar_init(&s.step_full[i], 1);    // the walker's chunk
      lzs::mbar_init(&s.step_empty[i], kConsumers / 32);
    }
    s.walker_done = 0;
    s.out_full = 0;
    s.marks = 0;
  }
  __syncthreads();
  uint8_t* ring = smem;
  int2* steps = reinterpret_cast<int2*>(smem + kByteSlots * kSlotBytes);
  if (warp == kCopyWarp) {
    copy_row(row, c, m, ring, s);
  } else if (warp == 0) {
    if (threadIdx.x == 0) {
      // JAX's inbytes * 8 in int32 (wraps)
      const int inbits =
          static_cast<int>(static_cast<unsigned>(__ldg(inbytes + b)) * 8u);
      walk(reinterpret_cast<const uint32_t*>(ring), steps, s, m, inbits,
           max_units, multi_stream, stats);
    }
  } else if (warp != 4) {
    const int ct = (warp == 6 ? 3 : warp - 1) * 32 + (threadIdx.x & 31);
    consume(steps, s, ct, out_cap, max_units, multi_stream, store, out_len,
            markers);
  }
}

template <class Store>
cudaError_t launch_scan(int rows, cudaStream_t stream, const uint8_t* comp,
                        int c, const int* inbytes, int max_units, int out_cap,
                        bool multi_stream, const Store& store, int* out_len,
                        int* markers, long long* stats) {
  const cudaError_t err = cudaFuncSetAttribute(
      scan_parse_kernel<Store>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return err;
  scan_parse_kernel<Store><<<rows, kScanThreads, kSmemBytes, stream>>>(
      comp, c, inbytes, max_units, out_cap, multi_stream, store, out_len,
      markers, stats);
  return cudaGetLastError();
}

// clock64 cycles of kProbeOps dependent instructions, a funnel shift and
// an add in turn (each one SASS instruction), on values the compiler
// cannot know.
__global__ void chain_latency_kernel(long long* out, int a, int b) {
  uint32_t x = static_cast<uint32_t>(a);
  const uint32_t y = static_cast<uint32_t>(b) | 1u;
  const long long t = clock64();
#pragma unroll 1
  for (int i = 0; i < kProbeOps / 32; ++i) {
#pragma unroll
    for (int j = 0; j < 16; ++j)
      asm volatile("shf.l.wrap.b32 %0, %0, %1, %0;\n\tadd.s32 %0, %0, %1;"
                   : "+r"(x) : "r"(y));
  }
  out[0] = clock64() - t;
  out[1] = x;                      // the chain's end, so that it stays
}

}  // namespace

// width 0: JAX's step-major records (rows of max_units) into `recs`; else
// the filled rows of `width` int32 (a multiple of 4, at least max_units,
// 16-byte aligned) into `recs`. `stats` may be null.
LZS_API int lzs_scan_parse(const uint8_t* comp, const int* inbytes, int rows,
                           int c, int max_units, int out_cap, int multi_stream,
                           int* recs, int width, int* out_len, int* markers,
                           long long* stats, int device, void* stream) {
  const lzs::DeviceGuard guard(device);
  if (rows < 1 || c < 0 || max_units < 0 || out_cap < 1 || width < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const bool multi = multi_stream != 0;
  if (width == 0) {
    const bool vec =
        max_units % 4 == 0 && reinterpret_cast<uintptr_t>(recs) % 16 == 0;
    return static_cast<int>(launch_scan(rows, s, comp, c, inbytes, max_units,
                                        out_cap, multi, StepMajor{recs, vec},
                                        out_len, markers, stats));
  }
  if (width % 4 != 0 || width < max_units ||
      reinterpret_cast<uintptr_t>(recs) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_scan(rows, s, comp, c, inbytes, max_units,
                                      out_cap, multi, Filled{recs, width},
                                      out_len, markers, stats));
}

// out: int64[2], the clock64 cycles of kProbeOps dependent instructions
// (chain_latency_kernel), one thread alone on the card, and the chain's
// last value.
LZS_API int lzs_chain_latency(long long* out, int a, int b, int device,
                              void* stream) {
  const lzs::DeviceGuard guard(device);
  const auto s = static_cast<cudaStream_t>(stream);
  chain_latency_kernel<<<1, 1, 0, s>>>(out, a, b);
  return static_cast<int>(cudaGetLastError());
}
