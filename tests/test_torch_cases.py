"""Seeded edge inputs for the row scans (K7-K9), the match extension's
breaks (K4) and fold (K5), the token walk's entries (K12), the bit pack
(K14+K15), sync (K16), expand (K17) and the raw decoder's heads.

tests/test_torch_scan.py, tests/test_torch_walk.py,
tests/test_torch_sync.py and tests/test_torch_expand.py hold the port's
plain versions to the JAX package (or, for the walk's entries, to a numpy
recurrence) on these inputs on the CPU; tests/test_torch_gpu.py holds the
kernels to the plain versions on them on the card. The module imports no
jax, so the GPU machine can import it; its own tests check that the
inputs have the properties they are made for.

Cumsum rows mix values near +-2^31 with small ones, so their sums wrap
many times in every piece a kernel splits a row into. Min/max rows rise,
fall or are noise over all of int32, with INT_MIN, INT_MAX and the
callers' sentinels -1 and 0x3FFFFFFF in every row: a rising row's running
max and suffix min change in every piece, a falling row's come from its
far end, across every piece. Fold rows are (score, off, n, ext_h) for
ext_breaks and then ext_fold: capped runs (score == cap, one offset) that
cross every multiple of 4096 (the chained scan's tiles), one that spans
two whole tiles, heads whose cap + ext_h lands at 0xFFFF, past it, or
wraps int32, rows that end in a capped head, and a ragged width. Breaks
rows are the same (score, off, n, ext_h) for K4 alone: capped runs whose
head and next break lie in different 4096- and 8192-element tiles (the
chained scan's two tile forms), heads at the start of a lane's group of
4, of a lane 0 group (128 elements), of a warp's part (512 and 1024) and
of a tile whose predecessor is capped with another offset (and, beside
them, predecessors with the same offset: no head), n past the row and n =
0. Pack units are (value, width) rows for pack_bits_batch: stretches of
width 0 over every 4096- and 8192-unit segment edge, a whole segment of
them and a whole row, totals that end on a word boundary or put the end
marker across one. Walk rows
are token
steps (0 and -1 count as 1) whose chains enter most tiles, skip whole
runs of 16 and of 128 tiles (the entry kernel's ring slot and its ring)
and, in row 0, leave the row with a step of 2^30.

Sync rows are emission-unit rows of a token sequence: a head per token
(9 bits for a literal, 2 + 7 or 11 + 2 or 4 for a copy), extension
nibbles of 4 bits right after the head of a copy of length >= 8 (one per
15 bytes past the 8th), bit offsets as the exclusive running sum of the
widths, so every parse step is at most 24 bits from the next and every
span boundary has one crossing step. Expand rows are cummax-filled record
rows ((opos << 13) | (is_copy << 11) | payload, -1 before the first
record), hand-made or from the port's own encoder and lane parse. Heads
rows are raw input for the per-bit heads (``bitpar._heads``): noise with
a run of 1 bits in each row (15-nibbles at every bit phase) that ends
exactly at, a bit, a nibble or a head's reach (17 bits) before or past a
boundary of the heads kernel's 16384-bit tiles, one run across several
tiles, a row of 1s alone, input lengths inside a run and past the row;
the raw fuzz streams are the reference encoder's of random, RLE,
periodic and already-compressed data, two concatenated and one cut.
"""

import functools

import numpy as np
import pytest
import torch

from lzs_tpu_torch import reference, spec
from lzs_tpu_torch.ops import decode2, encode, pext

# a copy of length >= 8 starting here in a wide row: its nibble chain
# crosses the next 8192-position boundary (each CTA of the sync kernel
# takes 8192 positions)
CHAINS = ((8000, 3000), (16300, 1600), (24560, 800))


def cumsum_rows(seed, b, w):
    """int32[b, w]: a third near 2^31 - 1, a third near -2^31, the rest
    small (negative ones too)."""
    rng = np.random.default_rng(seed)
    v = rng.integers(-1000, 1000, (b, w), dtype=np.int64)
    pick = rng.random((b, w))
    v[pick < 1 / 3] += (1 << 31) - 1000
    v[pick > 2 / 3] -= (1 << 31) - 1000
    return v.astype(np.int32)


I32 = np.iinfo(np.int32)


def minmax_rows(seed, b, w):
    """int32[b, w] for the running max (K8) and the suffix min (K7): each
    row holds random int32 values, INT_MIN, INT_MAX, and one -1 and one
    0x3FFFFFFF per 4096 positions. Rows rise (row % 3 == 0: sorted, then
    shuffled within windows of 64 positions), fall (1: a rising row
    reversed) or are shuffled whole (2)."""
    rng = np.random.default_rng(seed)
    v = rng.integers(I32.min, I32.max, (b, w), dtype=np.int64,
                     endpoint=True)
    k = -(-w // 4096)
    special = [I32.min, I32.max] + [-1] * k + [0x3FFFFFFF] * k
    v[:, :min(w, len(special))] = special[:w]
    v = np.sort(v, axis=1)
    window = np.argsort(np.arange(w) // 64 + rng.random((b, w)), axis=1)
    v = np.take_along_axis(v, window, axis=1)
    kind = np.arange(b) % 3
    v[kind == 1] = v[kind == 1, ::-1]
    v[kind == 2] = rng.permuted(v[kind == 2], axis=1)
    return v.astype(np.int32)


#: the match search's cap, and the ext_h values (past the random ones)
#: that the fold rows give the heads of their long runs: cap + ext_h at
#: 0xFFFF, one past, far past, and wrapping int32
FOLD_CAP = 12
FOLD_EXT_H = (0xFFFF - FOLD_CAP, 0x10000 - FOLD_CAP, 1 << 20,
              I32.max - 5)


def fold_rows(seed, b, w):
    """(score, off, n, ext_h) int32 rows of width ``w`` for ext_breaks and
    ext_fold at cap FOLD_CAP: 60% of the scores capped over offsets 1-3
    (short runs everywhere); around every multiple of 4096 a capped run of
    one offset from 300 before to 300 after it, whose head gets
    FOLD_EXT_H[(row + j) % 3] for the row's j-th run; in row 1 one run
    from 3000 to 12500 (over the whole tile 4096-8191 where the row is that
    wide), whose head gets FOLD_EXT_H[3]; other positions ext_h in
    [0, 5000). Rows 0, 1 and every third row have n past the row, so their
    runs are capped to the row's end."""
    rng = np.random.default_rng(seed)
    score = rng.integers(0, FOLD_CAP + 1, (b, w))
    score[rng.random((b, w)) < 0.6] = FOLD_CAP
    off = rng.integers(1, 4, (b, w))
    ext_h = rng.integers(0, 5000, (b, w))
    runs = [(max(k - 300, 0), min(k + 300, w), j % 3)
            for j, k in enumerate(range(4096, w, 4096))]
    for r in range(b):
        long = [(3000, min(12500, w), 3)] if r == 1 and w > 3000 else []
        for lo, hi, value in long or runs:
            score[r, lo:hi] = FOLD_CAP
            off[r, lo:hi] = 5 + r % 7
            score[r, lo - 1] = 0                # a head at lo
            ext_h[r, lo] = FOLD_EXT_H[(value + r) % 3 if value < 3 else 3]
    n = rng.integers(w // 2, w + 1, b)
    n[::3] = w + 20
    n[1:2] = w + 20
    return tuple(a.astype(np.int32) for a in (score, off, n, ext_h))


#: where a head starts a lane's group, a lane 0 group (128), a warp's
#: part at either tile form (512, 1024) and a tile (4096, 8192); the
#: element before each is capped too, with another offset
HEAD_STARTS = (4, 132, 128, 512, 1024, 4096, 8192)


def breaks_rows(seed, b, w):
    """(score, off, n, ext_h) int32 rows of width ``w`` for ext_breaks at
    cap FOLD_CAP, from fold_rows' random part: in each row r a capped run
    of one offset from 4096 k - 100 to 8192 (k + 1) + 50 + r, k = r % 3 +
    1, where the row holds it (its head and its next break in different
    tiles of either form); a head at each multiple of HEAD_STARTS[r % 7]
    past the run (past 0 where there is none) whose predecessor is capped
    with another offset, and at the 2 positions before each a capped
    predecessor with the same offset. Rows 0 and 2 have n past the row,
    row 1 n = 0."""
    score, off, n, ext_h = fold_rows(seed, b, w)
    for r in range(b):
        k = r % 3 + 1
        lo, hi = 4096 * k - 100, 8192 * (k + 1) + 50 + r
        if hi < w:
            score[r, lo - 1:hi + 1] = FOLD_CAP
            off[r, lo - 1] = 40
            off[r, lo:hi] = 41                  # a head at lo
            score[r, hi] = 0                    # its next break
        step = HEAD_STARTS[r % len(HEAD_STARTS)]
        first = hi + 1 if hi < w else 1
        for p in range(step * -(-first // step), w, step):
            score[r, p - 3:p + 2] = FOLD_CAP
            off[r, p - 3:p] = 30                # same offset: no head
            off[r, p:p + 2] = 31                # another: a head at p
    n[0], n[1:2], n[2:3] = w + 20, 0, w + FOLD_CAP
    return score, off, n, ext_h


#: pack segments: a cluster CTA takes 4096 units (8192 in rows past 32768)
PACK_SEGMENTS = (4096, 8192)


def pack_units(seed, b, m, live=1.0):
    """(value, width) int32[b, m] for pack_bits_batch: widths 4, 9, 11,
    13, 17, 25 (a share ``live`` of them; 0 elsewhere), values below
    2^width; width 0 from 300 before to 300 after every multiple of 4096,
    over the whole segment 8192-12287 in row 1, and over all of row 0; the
    other rows' totals end 0 (row 2), 23 (row 3: the 9-bit end marker then
    ends on a word boundary) and 28 bits (row 4: the marker straddles a
    word) into a word, by the widths of their last units."""
    rng = np.random.default_rng(seed)
    widths = np.array([4, 9, 11, 13, 17, 25])
    w = widths[rng.integers(0, len(widths), (b, m))]
    w[rng.random((b, m)) >= live] = 0
    for k in range(min(PACK_SEGMENTS), m, min(PACK_SEGMENTS)):
        w[:, max(k - 300, 0):k + 300] = 0
    if b > 1:
        w[1, 8192:12288] = 0
    w[0] = 0
    for r, rest in ((2, 0), (3, 23), (4, 28)):
        if r < b and m >= 8:
            w[r, -4:] = 4
            w[r, -8:-4] = 0
            # 4 live units of 4 to 13 bits move the total to `rest`
            need = (rest - int(w[r, :-4].sum()) - 16) % 32
            for j in range(4):
                add = min(need, 9)
                w[r, m - 4 + j] += add
                need -= add
    v = rng.integers(0, 1 << 25, (b, m)) & ((1 << w) - 1)
    return v.astype(np.int32), w.astype(np.int32)


#: tiles of the walk skipped by a long step: past one ring slot of the
#: entry kernel (16 tiles) and past its whole ring (128 tiles)
WALK_SKIPS = (20, 140)


def _funnel(row, at, step):
    """Route the chain through position ``at`` (its steps are at most 30,
    so it lands in the 30 positions before) and give ``at`` this step."""
    lo = max(at - 30, 0)
    row[lo:at] = at - np.arange(lo, at)
    row[at] = step


def walk_steps(seed, b, ntiles):
    """int32[b, ntiles * 128] token steps: short steps (-1 to 30); in odd
    rows a step over WALK_SKIPS[1] tiles in the row's first third and one
    over WALK_SKIPS[0] in its last; in row 0 a step of 2^30 in the middle,
    so its chain ends past the row. The chains take every long step."""
    rng = np.random.default_rng(seed)
    npos = ntiles * 128
    step = rng.integers(-1, 31, (b, npos))
    third = max(npos // 3, 1)
    for r in range(1, b, 2):
        _funnel(step[r], int(rng.integers(0, third)),
                WALK_SKIPS[1] * 128 + int(rng.integers(0, 128)))
        _funnel(step[r], int(rng.integers(npos - third, npos)),
                WALK_SKIPS[0] * 128 + int(rng.integers(0, 128)))
    _funnel(step[0], npos // 2, 1 << 30)
    return step.astype(np.int32)


def walk_entries_numpy(exits):
    """The entry rule, one tile at a time: the entry of tile t is the
    chain position before it; a chain inside tile t moves to its exit."""
    b, ntiles, tile = exits.shape
    entries = np.zeros((b, ntiles), np.int32)
    for r in range(b):
        c = 0
        for t in range(ntiles):
            entries[r, t] = c
            if t * tile <= c < (t + 1) * tile:
                c = int(exits[r, t, c - t * tile])
    return entries


def sync_row(rng, npos, n, *, chains=(), wide_off=False, end_span=None):
    """One unit row over ``n`` of ``npos`` positions.

    chains: (position, length) of long copies that start at those
    positions (the token before is cut short); wide_off: head offsets up to 2^15
    (above the record's 0xFFF clip); end_span: stop at the first token
    end past n/2 whose next multiple of end_span is < 24 bits on, and put
    the end marker there (end_bits a multiple of the span).
    Returns (starts, width, off, offs, end_bits, n).
    """
    starts = np.zeros(npos, bool)
    width = np.zeros(npos, np.int32)
    off = rng.integers(1, (1 << 15) if wide_off else 2048, npos)
    pending = sorted(chains)
    p = total = 0
    end_bits = None
    while p < n:
        if pending and p >= pending[0][0]:
            length = pending.pop(0)[1]
        else:
            kind = rng.random()
            length = (1 if kind < 0.45 else int(rng.integers(2, 8))
                      if kind < 0.8 else int(rng.integers(8, 200)))
            if pending:
                length = min(length, pending[0][0] - p)
        length = min(length, n - p)
        starts[p] = True
        if length == 1:
            width[p] = 9
        else:
            width[p] = 2 + (7 if off[p] < 128 else 11) + (
                2 if length <= 4 else 4)
            if length >= spec.MAX_SHORT_LENGTH:
                k = (length - spec.MAX_SHORT_LENGTH) // \
                    spec.MAX_EXTENDED_LENGTH + 1
                width[p + 1:p + 1 + k] = 4
        total += int(width[p:p + length].sum())
        p += length
        if end_span and 2 * p >= n:
            mark = -(-total // end_span) * end_span
            if mark - total < 24:
                end_bits, n = mark, p
                break
    offs = np.concatenate([[0], np.cumsum(width)[:-1]]).astype(np.int32)
    if end_bits is None:
        end_bits = total
    return starts, width, off.astype(np.int32), offs, end_bits, n


def sync_batch(seed, b, npos, span):
    """A batch of ``b`` unit rows: row 0 with the long copies of CHAINS
    (nibble chains whose owner lies in an earlier 8192-position segment),
    row 1 with offsets above 0xFFF, row 2 whose end_bits is a multiple of
    ``span`` (where a row is long enough to place one), row 3 empty, row 4
    a third full, the rest random lengths with either offset range.
    Returns numpy (starts bool, width, off, offs int32 [b, npos],
    end_bits, n int32 [b])."""
    rng = np.random.default_rng(seed)
    rows = []
    for r in range(b):
        kw = {}
        if r == 0:
            n, kw["chains"] = npos, [c for c in CHAINS if c[0] < npos]
        elif r == 1:
            n, kw["wide_off"] = npos, True
        elif r == 2:
            n, kw["end_span"] = npos, span
        elif r == 3:
            n = 0
        elif r == 4:
            n = npos // 3
        else:
            n = int(rng.integers(npos // 2, npos + 1))
            kw["wide_off"] = bool(r % 2)
        rows.append(sync_row(rng, npos, n, **kw))
    cols = list(zip(*rows))
    return (np.stack(cols[0]), np.stack(cols[1]), np.stack(cols[2]),
            np.stack(cols[3]), np.array(cols[4], np.int32),
            np.array(cols[5], np.int32))


def sync_kwargs(npos, span):
    return dict(span=span, nibbles=encode.NIBBLES_PER_STEP,
                short_len=spec.MAX_SHORT_LENGTH,
                ext_len=spec.MAX_EXTENDED_LENGTH,
                nslots=encode.sync_slots(npos, span))


def hand_fill(recs, s, stride=3):
    """Records (opos, is_copy, payload) at every ``stride``-th slot, -1
    between, cummax-filled as decode2._filled_records leaves them."""
    row = np.full(s, -1, np.int64)
    for k, (opos, is_copy, pay) in enumerate(recs):
        row[stride * k + stride - 1] = (opos << 13) | (is_copy << 11) | pay
    return np.maximum.accumulate(row).astype(np.int32)


@functools.lru_cache(maxsize=None)
def real_fill(data: bytes, block: int, span: int) -> np.ndarray:
    """Filled records of one block from the port's encoder and lane parse
    on the CPU (both pinned to JAX in test_torch_sync and
    test_torch_decode)."""
    x = np.zeros((1, block), np.uint8)
    x[0, :len(data)] = np.frombuffer(data, np.uint8)
    n = torch.tensor([len(data)], dtype=torch.int32)
    comp, _, sbit, sout, _ = encode.encode_batch_sync(
        torch.from_numpy(x), n, span=span)
    recs, _ = decode2._parse_full(comp, sbit, sout, span)
    return decode2._filled_records(recs)[0].numpy()


def expand_rows(out_cap, s):
    """Hand-made (records, n, stride) rows that fit ``s`` slots: one copy
    record over the rest of the row after a literal period of 1, 3, 27
    and (where the slots allow) 1999 bytes; a chain of offset-4 copies
    whose sources lie in the copy before, so chains run up to every chunk
    boundary; a row whose first record starts at 3 (status 3); a copy
    from before the block start (status 2); an empty block."""
    rows = []
    for period in (1, 3, 27, 1999):
        if period + 1 <= s:
            recs = [(k, 0, (k * 7 + 1) % 251) for k in range(period)]
            rows.append((recs + [(period, 1, period)], out_cap, 1))
    chain = [(k, 0, 65 + k) for k in range(4)]
    for m in range(1, out_cap // 4):
        if len(chain) + 2 > s:
            break
        chain += [(4 * m, 0, m % 251), (4 * m + 1, 1, 4)]
    rows.append((chain, out_cap, 1))
    rows.append(([(3, 0, 65), (4, 1, 1)], min(50, out_cap), 1))
    rows.append(([(0, 0, 65), (1, 1, 5), (9, 0, 66)], min(100, out_cap), 3))
    rows.append(([(0, 0, 65)], 0, 3))
    return rows


def _deep_chain() -> bytes:
    lits = [c for c in range(256) if c not in (65, 66)]
    return b"".join(bytes([lits[k % len(lits)], 65, 66])
                    for k in range(1300))[:3900]


def expand_batch(seed, out_cap, s=None):
    """Filled record rows (int32 [b, S]) and block lengths (int32 [b]).

    With ``s`` (a multiple of 128, >= 768): the hand-made rows at that
    width. Without: the hand-made rows plus three real blocks of 4096
    bytes, the widest record windows a chunk sees (random bytes at span
    160: lanes of about 18 literals, 28 slots each) and the deep copy
    chain at spans 160 and 2048, all padded to one width by repeating
    each row's last record (which changes no covering record)."""
    rng = np.random.default_rng(seed)
    real = []
    if s is None:
        noise = rng.integers(0, 256, 4096, dtype=np.uint8).tobytes()
        real = [(real_fill(noise, 4096, 160), 4096),
                (real_fill(_deep_chain(), 4096, 160), 3900),
                (real_fill(_deep_chain(), 4096, 2048), 3900)]
        s = max([len(f) for f, _ in real] + [out_cap // 2 + 16, 2048])
        s = -(-s // 128) * 128
    rows = expand_rows(out_cap, s)
    fills = [hand_fill(r, s, stride) for r, _, stride in rows]
    ns = [n for _, n, _ in rows]
    for f, n in real:
        fills.append(np.concatenate([f, np.full(s - len(f), f[-1],
                                                np.int32)]))
        ns.append(min(n, out_cap))
    return np.stack(fills), np.array(ns, np.int32)


#: bits of a row that one CTA of the heads kernel takes (csrc/heads.cu)
HEADS_TILE = 1 << 14
#: where the heads rows' runs of 1 bits end, from a tile boundary: at it,
#: a bit, a nibble and a head's reach (up to 17 bits) before and past it
HEADS_ENDS = (-21, -17, -16, -5, -4, -1, 0, 1, 3, 4, 15, 16, 17, 18, 21)


def heads_rows(seed, width):
    """Rows of ``width`` bytes (past 2 tiles) and their input bits.

    Row i < len(HEADS_ENDS): noise, with a run of 1 bits 200 to 2000 bits
    long that ends HEADS_ENDS[i] bits from the boundary of tile 1 or 2
    (alternately), a 0 bit right after it; its input bits are the row's,
    or end 7 bits before the run does, or go 32 bits past the row (an
    input window's span), by i % 3. Then a run from bit 3000 to 50 bits
    into tile 3 where the row reaches it (else to its end), and a row of
    1s alone. Returns (uint8[B, width], int32[B])."""
    rng = np.random.default_rng(seed)
    nbits = 8 * width
    assert nbits > 2 * HEADS_TILE + 64
    b = len(HEADS_ENDS) + 2
    bits = rng.integers(0, 2, (b, nbits), dtype=np.uint8)
    inbits = np.full(b, nbits, np.int64)
    for i, d in enumerate(HEADS_ENDS):
        end = HEADS_TILE * (1 + i % 2) + d
        bits[i, end - int(rng.integers(200, 2000)):end] = 1
        bits[i, end] = 0
        inbits[i] = (nbits, end - 7, nbits + 32)[i % 3]
    bits[-2, 3000:min(3 * HEADS_TILE + 50, nbits)] = 1
    bits[-1] = 1
    return np.packbits(bits, axis=1), inbits.astype(np.int32)


def raw_fuzz(seed):
    """30 raw streams of random, RLE, periodic and already-compressed
    data (the reference encoder's, up to 700 bytes in), two of them
    concatenated and one cut: (uint8[32, C] zero past each stream, int32
    lengths)."""
    rng = np.random.default_rng(seed)
    datas = []
    for _ in range(30):
        kind = rng.integers(0, 4)
        n = int(rng.integers(0, 700))
        if kind == 0:
            d = bytes(rng.integers(0, 256, n, dtype=np.uint8))
        elif kind == 1:
            d = bytes([int(rng.integers(0, 4))]) * n
        elif kind == 2:
            d = (bytes(rng.integers(97, 123, 13, dtype=np.uint8))
                 * (n // 13 + 1))[:n]
        else:
            d = reference.lzs_compress(bytes(rng.integers(0, 256, n,
                                                          dtype=np.uint8)))
        datas.append(d)
    streams = [reference.lzs_compress(d) for d in datas]
    streams += [streams[0] + streams[1], streams[2][:len(streams[2]) // 2]]
    buf = np.zeros((len(streams), max(map(len, streams)) + 8), np.uint8)
    for row, st in zip(buf, streams):
        row[:len(st)] = np.frombuffer(st, np.uint8)
    return buf, np.array([len(st) for st in streams], np.int32)


def test_cumsum_rows_wrap():
    v = cumsum_rows(0, 4, 1000).astype(np.int64)
    assert v.max() > (1 << 31) - 2000 and v.min() < -(1 << 31) + 2000
    # the exact running sums leave int32's range many times in every row
    wraps = np.diff(np.floor_divide(np.cumsum(v, axis=1) + (1 << 31),
                                    1 << 32), axis=1)
    assert ((wraps != 0).sum(axis=1) > 100).all()


@pytest.mark.parametrize("w", [8192, 200704])
def test_minmax_rows_properties(w):
    v = minmax_rows(w, 6, w)
    for value in (I32.min, I32.max, -1, 0x3FFFFFFF):
        assert (v == value).any(axis=1).all()
    # a rising row's scans change in every 4096-wide piece; a falling
    # row's come from its far end
    for rising in v[0::3]:
        for scan in (np.maximum.accumulate(rising),
                     np.minimum.accumulate(rising[::-1])[::-1]):
            pieces = np.unique(np.flatnonzero(np.diff(scan)) // 4096)
            assert len(pieces) == w // 4096
    for falling in v[1::3]:
        assert (np.maximum.accumulate(falling)[64:] == I32.max).all()
        assert (np.minimum.accumulate(falling[::-1])[64:] == I32.min).all()


@pytest.mark.parametrize("b,w", [(33, 8195), (3, 12290)])
def test_fold_rows_properties(b, w):
    score, off, n, ext_h = (torch.from_numpy(a) for a in fold_rows(w, b, w))
    packed = pext.ext_breaks_plain(score, off, n, FOLD_CAP)
    head, capped = (packed >> 2) & 1, (packed >> 1) & 1
    i = torch.arange(w)
    long = n > w + FOLD_CAP                    # rows whose runs all count
    assert long[0] and long[1]
    long[1] = False                            # its one long run
    for k in range(4096, w, 4096):
        # a capped run over the tile boundary, its head in the tile before
        assert capped[long, k - 300:k + 300].all()
        assert not head[long, k - 299:k + 300].any()
    assert capped[1, 3000:12500].all() and not head[1, 3001:12500].any()
    full = (FOLD_CAP + ext_h.long())[head == 1]
    for value in (0xFFFF, 0x10000, FOLD_CAP + (1 << 20)):
        assert (full == value).any()
    assert (full > I32.max).any()              # cap + ext_h wraps
    assert (capped[:, -1] == 1).any()          # a run reaches the row's end
    assert w % 4 and ((i[None] < n[:, None]) & (capped == 0)).any()


@pytest.mark.parametrize("b,w", [(7, 32768), (4, 16401), (33, 4099)])
def test_breaks_rows_properties(b, w):
    score, off, n, _ = (torch.from_numpy(a) for a in breaks_rows(w, b, w))
    packed = pext.ext_breaks_plain(score, off, n, FOLD_CAP)
    head, capped = (packed >> 2) & 1, (packed >> 1) & 1
    nxt = (packed >> 3) + torch.arange(w) + 1       # the next break
    assert n[0] > w and n[1] == 0 and not capped[1].any()
    runs = heads = 0
    for r in range(b):
        k = r % 3 + 1
        lo, hi = 4096 * k - 100, 8192 * (k + 1) + 50 + r
        if hi < w and r != 1:
            # the run's head and its next break: different tiles of both
            # forms
            assert head[r, lo] and capped[r, lo - 1]
            assert int(nxt[r, lo]) // 8192 > lo // 8192
            runs += 1
        step = HEAD_STARTS[r % len(HEAD_STARTS)]
        starts = torch.arange(step, max(w, step), step)
        starts = starts[(starts > hi) | (hi >= w)]
        starts = starts[capped[r, starts] == 1]
        if r != 1:
            assert head[r, starts].all()
            assert capped[r, starts - 1].all()      # another offset
            assert not head[r, starts - 1].any()    # the same offset
            heads += len(starts) > 0
    assert runs or w < 20000
    assert heads >= min(b - 1, 5)


@pytest.mark.parametrize("b,m,live", [(6, 32768, 0.3), (5, 32767, 1.0),
                                      (2, 65536, 0.2)])
def test_pack_units_properties(b, m, live):
    v, w = pack_units(m, b, m, live)
    assert (w >= 0).all() and (w <= 25).all()
    assert (v >= 0).all() and (v < (1 << w)).all()
    total = w.sum(axis=1)
    assert total[0] == 0 and not w[1, 8192:12288].any()
    assert [int(t) % 32 for t in total[2:5]] == [0, 23, 28][:b - 2]
    for k in range(4096, m, 4096):
        assert not w[:, k - 300:k + 300].any()
    assert (total + 9 + 8 <= 1 << 16).all() or m * live < 40000


@pytest.mark.parametrize("b,ntiles", [(3, 1), (4, 600)])
def test_walk_steps_properties(b, ntiles):
    step = walk_steps(ntiles, b, ntiles)
    assert step.shape == (b, ntiles * 128) and step.dtype == np.int32
    assert (step <= 0).any() and step[0].max() == 1 << 30
    for skip in WALK_SKIPS:
        assert (step[1] // 128 == skip).any()


def test_walk_entries_numpy_rule():
    """A chain through every tile, then one that leaves the row at once
    and passes its position through every later tile."""
    exits = np.arange(128 * 3, dtype=np.int32).reshape(1, 3, 128) + 128
    assert walk_entries_numpy(exits).tolist() == [[0, 128, 256]]
    exits[0, 0, 0] = 1 << 30
    assert walk_entries_numpy(exits).tolist() == [[0, 1 << 30, 1 << 30]]


@pytest.mark.parametrize("npos,span", [(1, 128), (96, 96), (8193, 288),
                                       (32768, 2048)])
def test_sync_batch_properties(npos, span):
    starts, width, off, offs, end_bits, n = sync_batch(npos, 33, npos, span)
    assert starts.shape == (33, npos) and starts.dtype == bool
    assert (np.diff(offs, axis=1) >= 0).all()
    assert (width[~starts] <= 4).all() and (width[starts] >= 9).all()
    assert (end_bits >= offs[:, -1]).all() and n[3] == 0
    if npos >= 96:
        assert end_bits[2] % span == 0 and end_bits[2] > 0
    for seg in range(8192, npos - 1000, 8192):
        # a nibble chain crosses each 8192-position boundary of row 0
        heads = np.flatnonzero(starts[0])
        assert (width[0, seg] == 4 and not starts[0, seg]
                and heads[np.searchsorted(heads, seg) - 1] < seg)
    if npos >= 96:
        assert (off[1][starts[1]] > 0xFFF).any()


@pytest.mark.parametrize("out_cap", [1000, 32767])
def test_expand_batch_properties(out_cap):
    for s in (768, None):
        rec, n = expand_batch(out_cap, out_cap, s)
        assert rec.shape[1] % 128 == 0 and rec.shape[1] >= 768
        assert (np.diff(rec, axis=1) >= 0).all()
        assert len(rec) == len(n) and (n <= out_cap).all()
    # the span-160 row: its first 1024-byte chunk (the expand kernel's
    # chunk and record tile) takes more than 1024 slots
    opos = np.where(rec[-3] >= 0, rec[-3] >> 13, -1)
    per_chunk = np.bincount(opos[opos >= 0] // 1024)
    assert per_chunk[0] > 1024


@pytest.mark.parametrize("width", [3 * 2048 + 1000, 40 * 2048 + 8])
def test_heads_rows_properties(width):
    rows, inbits = heads_rows(width, width)
    bits = np.unpackbits(rows, axis=1)
    assert rows.shape == (len(HEADS_ENDS) + 2, width)
    for i, d in enumerate(HEADS_ENDS):
        end = HEADS_TILE * (1 + i % 2) + d
        assert bits[i, end - 200:end].all() and bits[i, end] == 0
    assert bits[-1].all() and (inbits[2::3][:5] == 8 * width + 32).all()
    # the runs of 1s: one past tile 3's start (or the row's end), one
    # across every tile of the row
    assert bits[-2, 3000:min(3 * HEADS_TILE + 50, 8 * width)].all()
    assert -(-8 * width // HEADS_TILE) > (3 if width < 8192 else 33)


def test_raw_fuzz_properties():
    buf, lens = raw_fuzz(7)
    assert buf.shape[0] == 32 and (lens > 0).all()
    assert all(not buf[i, n:].any() for i, n in enumerate(lens))
