"""lzs_tpu_torch on a CUDA device: each kernel against its plain version.

These tests need the card and skip without one. They import no jax (the
GPU machine has none), so run them there without the JAX test fixtures:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Edge shapes the main path does not reach (one element, widths that are
not a multiple of the CTA or of a walk tile, 70000-wide rows, empty and
one-position walks, a huge step, hand-made records that set every status
bit, output rows past the shared-memory limit, a capped run head at a
row's last position) are compared bitwise with the plain versions on the
same CUDA tensors, as are the bench shapes of the raw decoder
(303104-position walks, 33792-wide cumsums) and of the match search
(256 x 32768, and the probe tier's gathers at 256 x 8320 words) and of
the container decode's lane parse (256 blocks x 146 lanes at span 2048,
from the codec's own encode on the card; corrupt records, one lane,
unaligned and odd byte rows); the sync and expand kernels also take the
seeded edge rows of tests/test_torch_cases.py (sync: 1 to 32768
positions over one to four CTAs of a cluster, 16-aligned and unaligned
rows; expand: fewer rows than SMs and more; the row cumsum: both tile
forms, values that wrap, 1 to 1024 rows up to 2^20 wide, and a CUDA
graph replay; the row max and suffix min on rows at INT_MIN and INT_MAX
in the same forms, and the five chained scans interleaved on one
stream; the match extension's breaks (K4) on runs across tiles and heads
at lane, warp and tile starts; the bit pack over clusters of 1 to 8 CTAs
(1 to 65536 units, zero-width segments, streams past cap_bytes); the
walk's entries: 1 to 300 rows of 1 to 6272 tiles,
skips past a ring slot and a ring, chains past the row; the mask rank
(K6) at batch 33 on ragged and misaligned rows and bytes other than 0/1;
the raw decoder's scan parse, both stores, at batch 33 on encoded,
truncated, concatenated and noise streams, with a budget that cuts, and
on the 2^18 stream in rows wider than its shared-memory ring; the raw
decoder's heads kernel, one launch a call, on the raw fuzz batch, a
batch shaped like the IPComp burst, rows of up to 41 tiles with runs of
15-nibbles at and across tile boundaries, clamping out_caps and
continuation heads, tests/test_torch_cases.py's heads rows); the codec's
bytes (also a 256-block container), the probe's run lengths and the raw
decoder's output on the card are compared with the CPU's. The streaming
codec's match search runs at batch 1: both backends at every pool of
the stream (256 to 32768, n at the pool and below it) with every kernel
call held to its plain version, the exhaustive plane's K7 rows at batch
33, and 256 KiB of the bench corpus streamed on the card against the
CPU and the C encoder. The codec profiles' match tables (windows 2047,
2174, 4095) and far-offset tokens equal the CPU's on the card; the raw
decoder's windows past 2^18 output bytes equal the CPU and the input;
the CLI's raw decode takes the device route at every size, a raw file
past 2^25 bytes of input included (windows of the input), and a token
whose run of extension nibbles spans some 2.5 input windows;
DistributedCodec on an NCCL world of one equals BlockCodec; and the
session codec (one carried history a link) at batch 33 equals its CPU
form call for call, its histories too, while ``encode_batch`` with a
zero ``start`` launches what it launches without one. The match search's
gram kernels (``gram_keys``, ``rank_lcp``) equal their plain forms at
caps 2 to 16 (no key1, an int32 one, an int64 one) on rows of one byte,
rows that a tile crosses, 1 x 32768, 256 x 32768, 8192 x 1500 and 8192 x
3547, and ``candidates_batch`` on the card equals the CPU's on a
256-block container of 32768-byte rows and on 8192 session rows. The
probe's span compare (``probe_span``) equals its plain form on the
seeded wave lanes of tests/test_torch_cases.py at the cells' wave
shapes (8192 x 1500, 8192 x 3547, 1024 x 32768, 1024 lanes), at batch 1
and with every lane empty or live, one launch a wave. Each
path (main, raw, scan, stream, stream_block, coders, cli, dist) launches
the kernels that ``chip_smoke.PATH_KERNELS`` lists for it and no others,
a match search its documented counts, and every kernel of the library is
on some path.
"""

import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from lzs_tpu_torch.blocks import BlockCodec, pad_blocks
from lzs_tpu_torch.sessions import SessionCodec
from lzs_tpu_torch.ops import (_kernels, bitpar, decode, decode2, encode,
                               pcand, pexpand, pext, pgather, ppack, psync,
                               pwalk, sortmatch)

from test_torch_cases import (FOLD_CAP, PROBE_NO_LANE, WALK_SKIPS,
                              breaks_rows, cumsum_rows, expand_batch,
                              fold_rows, hand_fill, heads_rows, minmax_rows,
                              pack_units, probe_lanes, raw_fuzz, sync_batch,
                              sync_kwargs, walk_steps)
from test_torch_sessions import _batch, _plan, _text
from test_torch_trace import _runs_data

import chip_smoke
from chip_smoke import PATH_KERNELS, RAW_KERNELS, check_launches

pytestmark = pytest.mark.gpu

END = (0b110000000, 9)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _rows(seed, b, w, dev):
    rng = np.random.default_rng(seed)
    v = rng.integers(-(1 << 20), 1 << 20, (b, w), dtype=np.int64)
    pick = rng.random((b, w))
    v[pick < 0.15] = -1
    v[pick > 0.85] = 0x3FFFFFFF
    return torch.from_numpy(v.astype(np.int32)).to(dev)


def _equal(got, want):
    for g, w in zip(got, want, strict=True):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)


@pytest.mark.parametrize("b,w", [(1, 1), (33, 1000), (5, 1025),
                                 (2, 38656), (3, 70000)])
def test_rowscan_kernels(cuda, b, w):
    v = _rows(b + w, b, w, cuda)
    before = _kernels.CUMMAX.launches, _kernels.RCUMMIN.launches
    _equal([pext.cummax_rows(v), pext.rcummin_rows(v)],
           [pext.cummax_rows_plain(v), pext.rcummin_rows_plain(v)])
    assert (_kernels.CUMMAX.launches, _kernels.RCUMMIN.launches) == (
        before[0] + 1, before[1] + 1)


@pytest.mark.parametrize("b,w", [(33, 1), (33, 33), (33, 33792)])
def test_cumsum_kernel(cuda, b, w):
    v = _rows(w, b, w, cuda)
    before = _kernels.CUMSUM.launches
    got = pext.cumsum_rows_wide(v)
    _equal([got], [pext.cumsum_rows_plain(v)])
    assert got.dtype == torch.int32
    assert _kernels.CUMSUM.launches == before + 1


#: the chained row scans (K7-K9): wrapper, plain version, kernel, and the
#: seeded rows (tests/test_torch_cases.py) that each is tested on
SCANS = {
    "rcummin": (pext.rcummin_rows, pext.rcummin_rows_plain, _kernels.RCUMMIN,
                minmax_rows),
    "cummax": (pext.cummax_rows, pext.cummax_rows_plain, _kernels.CUMMAX,
               minmax_rows),
    "cumsum": (pext.cumsum_rows_wide, pext.cumsum_rows_plain,
               _kernels.CUMSUM, cumsum_rows),
}


def _epoch(dev):
    """The chained scans' first status word on the current stream: the
    epoch, and the count of CTAs done (0 between launches) above it."""
    return int(_kernels.stream_words(dev, 1)[0])


def _chain_form(scan, b, w, shift, dev):
    """One chained scan at (b, w), on its seeded rows (4 bytes past a
    16-byte boundary when ``shift``): in its tile form, one launch,
    bitwise equal to the plain version, the epoch moved on by one."""
    wrapper, plain, kernel, rows = SCANS[scan]
    v = torch.from_numpy(rows(b * w, b, w)).to(dev)
    if shift:
        v = _misaligned(v)
    sms = _kernels.sm_count(dev.index)
    wide = b * -(-w // pext.SUM_TILES[1]) >= 4 * sms
    assert pext.cumsum_tile(b, w, sms) == pext.SUM_TILES[wide]
    wrapper(v)                               # the words at their size
    epoch = _epoch(dev)
    before = kernel.launches
    got = wrapper(v)
    assert kernel.launches == before + 1
    _equal([got], [plain(v)])
    assert _epoch(dev) == epoch + 1


@pytest.mark.parametrize("shift", [0, 1])
@pytest.mark.parametrize("b,w", [
    (1, 1), (1, 1025), (2, 16401), (4, 200704), (1, 89216), (1, 1 << 20),
    (33, 33792), (131, 16417), (133, 1025), (256, 33792), (1024, 1025),
    (1024, 75776)])
def test_cumsum_kernel_forms(cuda, b, w, shift):
    """Values near +-2^31 (every tile's sum wraps), bitwise equal to
    torch.cumsum, in both tile forms: 4096 for few rows (1 to 133 here, a
    row over up to 256 tiles, so look-backs past 32 tiles), 8192 where the
    rows make 4 tiles per SM (256 x 33792, 1024 rows); ragged ends (16401,
    16417, 1025, 1); rows 4 bytes past a 16-byte boundary (shift). Each
    call is one launch, moves the epoch in its stream's words on by one
    and leaves no CTA counted there."""
    _chain_form("cumsum", b, w, shift, cuda)


@pytest.mark.parametrize("shift", [0, 1])
@pytest.mark.parametrize("b,w", [
    (1, 1), (1, 1025), (2, 16401), (4, 200704), (1, 89216), (33, 33792),
    (131, 16417), (256, 32768), (256, 33792), (256, 38656), (1024, 75776)])
@pytest.mark.parametrize("scan", ["rcummin", "cummax"])
def test_minmax_kernel_forms(cuda, scan, b, w, shift):
    """K7 and K8 on rows that hold INT_MIN, INT_MAX, -1 and 0x3FFFFFFF,
    rising, falling and shuffled, at the cumsum's tile forms and the
    paths' shapes (the 2^18 row's 4 x 200704 and 1 x 89216, the encoder's
    256 x 32768, the fill's 256 x 38656, the raw chains' 1024 x 75776,
    whose 10,240 CTAs are more than the card holds at once, so K7's CTAs
    must take the tiles from the row's end); ragged and misaligned rows,
    where K7's walk starts on the ragged tile."""
    _chain_form(scan, b, w, shift, cuda)


def _fold_inputs(seed, b, w, dev):
    """The seeded fold rows on the card as ext_fold takes them: (packed,
    ext_h, score), packed from the plain ext_breaks."""
    score, off, n, ext_h = (torch.from_numpy(a).to(dev)
                            for a in fold_rows(seed, b, w))
    return pext.ext_breaks_plain(score, off, n, FOLD_CAP), ext_h, score


def _breaks_inputs(seed, b, w, dev):
    """The seeded breaks rows on the card as ext_breaks takes them:
    (score, off, n)."""
    return tuple(torch.from_numpy(a).to(dev)
                 for a in breaks_rows(seed, b, w)[:3])


def test_chain_scans_interleave(cuda):
    """K7, K8, K9, K5 and K4 alternate on one stream, on two shapes (two
    tile forms; K5 and K4 at the encoder's 256 x 32768), sharing its status
    words and epoch: every result exact, the epoch moved on by five per
    round."""
    few = torch.from_numpy(minmax_rows(1, 4, 200704)).to(cuda)
    many = torch.from_numpy(minmax_rows(2, 256, 33792)).to(cuda)
    fold = _fold_inputs(3, 256, 32768, cuda)
    breaks = _breaks_inputs(4, 256, 32768, cuda)
    order = ("rcummin", "cummax", "cumsum")
    for v in (few, many):                    # the words at their size
        for scan in order:
            SCANS[scan][0](v)
    for first, second in ((few, many), (many, few)):
        epoch = _epoch(cuda)
        got = [SCANS[scan][0](v)
               for scan, v in zip(order, (first, second, first))]
        got.append(pext.ext_fold(*fold, FOLD_CAP))
        got.append(pext.ext_breaks(*breaks, FOLD_CAP))
        _equal(got, [SCANS[scan][1](v)
                     for scan, v in zip(order, (first, second, first))]
               + [pext.ext_fold_plain(*fold, FOLD_CAP),
                  pext.ext_breaks_plain(*breaks, FOLD_CAP)])
        assert _epoch(cuda) == epoch + 5


def _scan_call(scan, seed, dev):
    """A chained scan's call and its plain version on its seeded rows: K7-K9
    on 4 x 200704, K5 (``fold``) and K4 (``breaks``) on 4 x 32768 fold
    and breaks rows."""
    if scan == "fold":
        args = _fold_inputs(seed, 4, 32768, dev)
        return (lambda: pext.ext_fold(*args, FOLD_CAP),
                lambda: pext.ext_fold_plain(*args, FOLD_CAP))
    if scan == "breaks":
        args = _breaks_inputs(seed, 4, 32768, dev)
        return (lambda: pext.ext_breaks(*args, FOLD_CAP),
                lambda: pext.ext_breaks_plain(*args, FOLD_CAP))
    wrapper, plain, _, rows = SCANS[scan]
    v = torch.from_numpy(rows(seed, 4, 200704)).to(dev)
    return lambda: wrapper(v), lambda: plain(v)


@pytest.mark.parametrize("scan", [*SCANS, "fold", "breaks"])
def test_cumsum_epoch_wrap(cuda, scan):
    """The launch of the last 30-bit tag clears the status words and
    starts the epoch over; each chained scan (K5 and K4 too) stays exact on
    both sides of it."""
    call, plain = _scan_call(scan, 7, cuda)
    want = plain()
    _equal([call()], [want])
    words = _kernels.stream_words(cuda, 1)
    words[0] = (1 << 30) - 2                 # the next tag is 2^30 - 1
    _equal([call()], [want])
    assert int(words[0]) == 0 and not words[1:].any()
    _equal([call()], [want])
    assert int(words[0]) == 1 and words[1:].any()


@pytest.mark.parametrize("scan", list(SCANS))
def test_cumsum_graph_replays(cuda, scan):
    """A CUDA graph that captured a chained scan replays it exactly on new
    inputs (the launch's tag comes from the device-side epoch)."""
    wrapper, plain, _, rows = SCANS[scan]
    v = torch.from_numpy(rows(3, 4, 200704)).to(cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        wrapper(v)                               # the stream's words
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = wrapper(v)
    for seed in (4, 5, 6):
        v.copy_(torch.from_numpy(rows(seed, 4, 200704)))
        graph.replay()
        torch.cuda.synchronize()
        _equal([out], [plain(v)])


def test_cumsum_keeps_its_words(cuda):
    """The 2^18 slot row: calls after the first reuse their stream's words
    as they are (nothing allocates or clears them per call)."""
    v = torch.from_numpy(cumsum_rows(1, 1, 89216)).to(cuda)
    want = pext.cumsum_rows_plain(v)
    _equal([pext.cumsum_rows_wide(v)], [want])
    words = _kernels.stream_words(cuda, 1)
    for _ in range(3):
        _equal([pext.cumsum_rows_wide(v)], [want])
    assert _kernels.stream_words(cuda, 1) is words


def _rank_inputs(seed, b, w, dev):
    """Rank LCPs in [0, 12], sorted positions that permute each row, and
    block lengths below the row width in every other row."""
    rng = np.random.default_rng(seed)
    plcp = rng.integers(0, 13, (b, w))
    p = rng.permuted(np.tile(np.arange(w), (b, 1)), axis=1)
    n = np.full(b, w)
    n[1::2] = rng.integers(1, w, len(n[1::2]))
    return [torch.from_numpy(a.astype(np.int32)).to(dev) for a in (plcp, p, n)]


@pytest.mark.parametrize("window", [64, 2047])
@pytest.mark.parametrize("k", [2, 12])
@pytest.mark.parametrize("b,w", [(33, 1000), (5, 1025), (3, 4097),
                                 (2, 16384), (256, 32768)])
def test_perk_level(cuda, b, w, k, window):
    """Random segments, plus one row that is one segment (plcp >= k but at
    rank 0) and one of singletons (plcp = 0); the widths give the sort
    network 1024 to 32768 slots."""
    plcp, p, n = _rank_inputs(b * w + k, b, w, cuda)
    plcp[0] = 12
    plcp[0, 0] = 0
    plcp[-1] = 0
    # a running best of lower levels, -1 where none matched
    lower = torch.randint(2, k + 1, (b, w), dtype=torch.int32, device=cuda)
    pk = torch.where(plcp > 6, (lower << 16) | (32768 - plcp - 1), -1)
    pk0 = pk.clone()
    before = _kernels.PERK_LEVEL.launches
    got = pcand.perk_level(plcp, p, n, pk, k, window)
    assert _kernels.PERK_LEVEL.launches == before + 1
    _equal([got], [pcand.perk_level_plain(plcp, p, n, pk, k, window)])
    assert torch.equal(pk, pk0)
    assert ((got[0] >> 16) == k).any()         # one segment: hits
    assert torch.equal(got[-1], pk[-1])        # singletons: none


@pytest.mark.parametrize("w", [1000, 32768])
def test_perk_level_position_missing_from_p_keeps_pk(cuda, w):
    """A p that repeats one position and so lacks another: with no hit in
    the level (singletons), every position keeps pk, the missing one too."""
    plcp, p, n = _rank_inputs(w, 2, w, cuda)
    plcp.zero_()
    p[:, 1] = p[:, 0]
    pk = _rows(w + 1, 2, w, cuda).clamp_min(-1)
    assert torch.equal(pcand.perk_level(plcp, p, n, pk, 2, 2047), pk)
    assert torch.equal(pcand.perk_level_plain(plcp, p, n, pk, 2, 2047), pk)


def _gram_rows(seed, b, w, dev):
    """Text-like rows with bytes on both sides of the sign bit and random
    bytes, every other row zero past 9/10 of its width."""
    rng = np.random.default_rng(seed)
    x = rng.integers(97, 101, (b, w))
    pick = rng.random((b, w))
    sign, rand = pick < 0.1, pick > 0.97
    x[sign] = rng.choice([0x00, 0x7F, 0x80, 0xFF], int(sign.sum()))
    x[rand] = rng.integers(0, 256, int(rand.sum()))
    x[1::2, w * 9 // 10:] = 0
    return torch.from_numpy(x.astype(np.int32)).to(dev)


@pytest.mark.parametrize("cap", [2, 8, 9, 12, 13, 16])
@pytest.mark.parametrize("b,w", [(3, 1), (33, 1000), (1, 32768),
                                 (256, 32768), (8192, 1500), (8192, 3547)])
def test_gram_kernels(cuda, b, w, cap):
    """gram_keys and rank_lcp, one launch a call, bitwise their plain forms
    on the same CUDA tensors: no key1 (cap <= 8), an int32 key1 and an
    int64 one; a row of one, rows that a CTA's tile crosses, the stream's
    batch 1 and the compress cells' shapes."""
    x = _gram_rows(b * w + cap, b, w, cuda)
    launches = (_kernels.GRAM_KEYS.launches, _kernels.RANK_LCP.launches)
    key0, key1 = sortmatch.gram_keys(x, cap)
    want0, want1 = sortmatch.gram_keys_plain(x, cap)
    _equal([key0], [want0])
    assert (key1 is None) == (want1 is None) == (cap <= 8)
    if key1 is not None:
        _equal([key1], [want1])
    del key0, key1, want0, want1
    s0, key1, perm = sortmatch.gram_sort(x, cap)
    got = sortmatch.rank_lcp(s0, key1, perm, cap)
    _equal(got, sortmatch.rank_lcp_plain(s0, key1, perm, cap))
    assert (_kernels.GRAM_KEYS.launches, _kernels.RANK_LCP.launches) == (
        launches[0] + 2, launches[1] + 1)


@pytest.mark.parametrize("rows", ["container", "sessions"])
def test_candidates_batch_on_card_equals_cpu(cuda, rows):
    """The match search's candidates on the card equal the CPU's on a
    256-block container's 32768-byte rows and on 8192 session rows of
    3547 bytes (a 2047-byte history and an IMIX packet, zero past it)."""
    if rows == "container":
        b, w = 256, 32768
        x = np.frombuffer(_corpus_like(22, b * w - 100), np.uint8)
        x = np.concatenate([x, np.zeros(100, np.uint8)]).reshape(b, w)
        n = np.full(b, w)
        n[-1] = w - 100
    else:
        b, w = 8192, 3547
        rng = np.random.default_rng(22)
        x = np.frombuffer(_corpus_like(23, b * w), np.uint8).reshape(b, w)
        n = 2047 + rng.choice([40, 576, 1500], b, p=[7 / 12, 4 / 12, 1 / 12])
        x = np.where(np.arange(w) < n[:, None], x, 0)
    x = torch.from_numpy(x.astype(np.int32))
    n = torch.from_numpy(n.astype(np.int32))
    before = _kernels.GRAM_KEYS.launches
    got = sortmatch.candidates_batch(x.to(cuda), n.to(cuda))
    assert _kernels.GRAM_KEYS.launches == before + 1
    _equal([g.cpu() for g in got], sortmatch.candidates_batch(x, n))


@pytest.mark.parametrize("b,w", [(33, 1000), (5, 1025), (256, 32768)])
def test_ext_kernels(cuda, b, w):
    rng = np.random.default_rng(w)
    score = rng.integers(0, 13, (b, w))
    score[rng.random((b, w)) < 0.6] = 12
    off = rng.integers(1, 4, (b, w))          # few offsets: runs form
    score[:, -3:] = 12
    off[:, -3:] = [5, 5, 7]
    n = rng.integers(5, w + 40, b)
    n[0] = w + 20             # row 0 ends in a capped head at i = N - 1
    st, ot, nt = (torch.from_numpy(a.astype(np.int32)).to(cuda)
                  for a in (score, off, n))
    before = _kernels.EXT_BREAKS.launches, _kernels.EXT_FOLD.launches
    packed = pext.ext_breaks(st, ot, nt, 12)
    _equal([packed], [pext.ext_breaks_plain(st, ot, nt, 12)])
    assert int(packed[0, -1]) & 0b110 == 0b110
    assert ((packed & 1) != 0).any()
    ext_h = torch.from_numpy(rng.integers(0, 5000, (b, w)).astype(
        np.int32)).to(cuda)
    _equal([pext.ext_fold(packed, ext_h, st, 12)],
           [pext.ext_fold_plain(packed, ext_h, st, 12)])
    assert (_kernels.EXT_BREAKS.launches, _kernels.EXT_FOLD.launches) == (
        before[0] + 1, before[1] + 1)


@pytest.mark.parametrize("shift", [0, 1])
@pytest.mark.parametrize("b,w", [(256, 32768), (1, 32768), (1, 1), (2, 5),
                                 (33, 8195), (3, 12290), (131, 4097)])
def test_ext_fold_kernel_forms(cuda, b, w, shift):
    """K5 on the seeded fold rows (capped runs over every 4096-element
    tile boundary and over a whole tile, cap + ext_h at, past and
    wrapping 0xFFFF, runs to the row's end): the encoder's 256 x 32768 (the
    8192 tile), one row, ragged widths, rows 4 bytes past a 16-byte
    boundary (shift: scalar loads and stores). Each call is one launch and
    moves the chained scans' epoch on by one."""
    args = _fold_inputs(w, b, w, cuda)
    if shift:
        args = tuple(_misaligned(a) for a in args)
    sms = _kernels.sm_count(cuda.index)
    wide = b * -(-w // pext.SUM_TILES[1]) >= 4 * sms
    assert pext.cumsum_tile(b, w, sms) == pext.SUM_TILES[wide]
    pext.ext_fold(*args, FOLD_CAP)           # the words at their size
    epoch = _epoch(cuda)
    before = _kernels.EXT_FOLD.launches
    got = pext.ext_fold(*args, FOLD_CAP)
    assert _kernels.EXT_FOLD.launches == before + 1
    _equal([got], [pext.ext_fold_plain(*args, FOLD_CAP)])
    assert _epoch(cuda) == epoch + 1


@pytest.mark.parametrize("shift", [0, 1])
@pytest.mark.parametrize("b,w", [(256, 32768), (1, 32768), (7, 32768),
                                 (4, 16401), (33, 4099), (131, 4097), (2, 5),
                                 (1, 1)])
def test_ext_breaks_kernel_forms(cuda, b, w, shift):
    """K4 on the seeded breaks rows (runs whose head and next break lie in
    different tiles of both forms; heads at lane, lane 0, warp and tile
    starts after a capped predecessor with another offset, and positions
    after one with the same offset; n past the row and n = 0; the fold
    rows' runs over every 4096-element tile boundary): the encoder's 256 x
    32768 (the 8192 tile), one row (4096), ragged widths, rows 4 bytes past
    a 16-byte boundary (shift: scalar loads and stores). Each call is one
    launch and moves the chained scans' epoch on by one."""
    args = _breaks_inputs(w, b, w, cuda)
    if shift:
        args = tuple(_misaligned(a) if a.dim() == 2 else a for a in args)
    sms = _kernels.sm_count(cuda.index)
    wide = b * -(-w // pext.SUM_TILES[1]) >= 4 * sms
    assert pext.cumsum_tile(b, w, sms) == pext.SUM_TILES[wide]
    pext.ext_breaks(*args, FOLD_CAP)         # the words at their size
    epoch = _epoch(cuda)
    before = _kernels.EXT_BREAKS.launches
    got = pext.ext_breaks(*args, FOLD_CAP)
    assert _kernels.EXT_BREAKS.launches == before + 1
    _equal([got], [pext.ext_breaks_plain(*args, FOLD_CAP)])
    assert _epoch(cuda) == epoch + 1
    if w > 4096:
        assert ((got & 1) != 0).any() and ((got & 4) != 0).any()


@pytest.mark.parametrize("b,w", [(1, 1), (33, 1000), (5, 1025),
                                 (256, 32768)])
def test_rank_mask_kernel(cuda, b, w):
    gen = torch.Generator(device=cuda).manual_seed(w)
    mask = torch.rand((b, w), generator=gen, device=cuda) < 0.3
    mask[0] = True
    before = _kernels.RANK_MASK.launches
    got = pext.rank_mask(mask)
    _equal([got], [pext.rank_mask_plain(mask)])
    assert got.dtype == torch.int32
    assert _kernels.RANK_MASK.launches == before + 1


@pytest.mark.parametrize("shift", [0, 1])
@pytest.mark.parametrize("w", [1, 3, 4095, 4096, 8193, 32768, 75776])
def test_rank_mask_kernel_forms(cuda, w, shift):
    """K6 on the chained scan at batch 33: its tile forms (4096 or 8192
    bytes a CTA), ragged widths, a base 1 byte past a 4-byte boundary
    (the scalar loads), an all-set and an all-clear row; one launch."""
    b = 33
    gen = torch.Generator(device=cuda).manual_seed(w + shift)
    flat = torch.rand(b * w + shift, generator=gen, device=cuda) < 0.4
    mask = flat[shift:].view(b, w)
    mask[0] = True
    mask[1] = False
    assert (mask.data_ptr() % 4 == 0) == (shift == 0)
    before = _kernels.RANK_MASK.launches
    got = pext.rank_mask(mask)
    _equal([got], [pext.rank_mask_plain(mask)])
    assert _kernels.RANK_MASK.launches == before + 1
    assert got[0, -1] == w - 1 and not got[1].any()


@pytest.mark.parametrize("w", [4095, 4096, 32768])
def test_rank_mask_kernel_counts_any_nonzero_byte(cuda, w):
    """A bool mask viewed from bytes other than 0 and 1: each counts 1,
    as a bool does (the plain version counts the 0/1 mask of the same
    bytes)."""
    gen = torch.Generator(device=cuda).manual_seed(w)
    raw = (torch.rand((33, w), generator=gen, device=cuda) * 4).to(
        torch.uint8)
    raw[0, :] = 0xFF
    _equal([pext.rank_mask(raw.view(torch.bool))],
           [pext.rank_mask_plain(raw != 0)])


@pytest.mark.parametrize("b,w,q,shift", [
    (3, 1, 7, 0), (5, 1000, 333, 0), (1, 1000, 4099, 0), (1, 5, 4, 0),
    (4, 1, 1024, 0), (4, 300, 1024, 1), (256, 8320, 26624, 0),
    (256, 32768, 1024, 0), (256, 1024, 32768, 0)])
def test_gather_kernel(cuda, b, w, q, shift):
    """Scalar (Q % 4 != 0, or indices not 16-byte aligned: ``shift``) and
    int4 forms, W = 1, B = 1 and the probe's three shapes."""
    rng = np.random.default_rng(w + q)
    tab = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, (b, w),
                                        dtype=np.int64).astype(np.int32))
    idx = torch.from_numpy(rng.integers(-3, w + 3, (b, q)).astype(np.int32))
    tab = tab.to(cuda)
    idx = torch.cat([idx.new_zeros(shift), idx.flatten()]).to(cuda)[
        shift:].view(b, q)
    before = _kernels.GATHER_BIG.launches
    _equal([pgather.gather_big(tab, idx)],
           [pgather.gather_big_plain(tab, idx)])
    assert _kernels.GATHER_BIG.launches == before + 1


@pytest.mark.parametrize("b,npos,p,cap", [
    (8192, 1500, 1024, 12), (8192, 3547, 1024, 12), (1024, 32768, 1024, 12),
    (1, 32768, 1024, 12), (1, 300, 300, 12), (37, 2100, 333, 16),
    (13, 1500, 77, 2)])
def test_probe_span_kernel(cuda, b, npos, p, cap):
    """Tier 1 of the probe, one launch, bitwise its plain form on the
    seeded wave lanes (``probe_lanes``: random, all-live and empty rows,
    runs of 47 to 49 bytes, a run that reaches n inside the span, a
    clamped at N - 1, offsets 2047, 2048, 4095 and 32767) at the cells'
    wave shapes (IPComp's and the sessions' 8192 rows of 1500 and 3547,
    the container's 1024 x 32768, 1024 lanes), at batch 1, and at lane
    counts that no CTA divides."""
    x, n, srt = (torch.from_numpy(a).to(cuda)
                 for a in probe_lanes(npos + b, b, npos, p, cap))
    before = _kernels.PROBE_SPAN.launches
    got = sortmatch.probe_span(x, n, srt, cap)
    assert _kernels.PROBE_SPAN.launches == before + 1
    _equal(got, sortmatch.probe_span_plain(x, n, srt, cap))
    assert (got[1] != sortmatch._BIG).any() or b == 1


@pytest.mark.parametrize("b,npos,p", [(8192, 1500, 1024), (3, 32768, 1024),
                                      (2, 5, 5)])
def test_probe_span_kernel_all_empty_or_live(cuda, b, npos, p):
    """Every lane empty (0 and _BIG, after one load each), then every lane
    live at offsets 1 to 32767 over one repeated byte, where every run
    fills the span or reaches n."""
    rng = np.random.default_rng(b + npos)
    x = torch.full((b, npos), 5, dtype=torch.int32, device=cuda)
    n = torch.from_numpy(rng.integers(1, npos + 1, b).astype(np.int32)).to(
        cuda)
    x[torch.arange(npos, device=cuda) >= n[:, None]] = 0
    empty = torch.full((b, p), PROBE_NO_LANE, dtype=torch.int32, device=cuda)
    cln, dact = sortmatch.probe_span(x, n, empty, 12)
    assert not cln.any() and (dact == sortmatch._BIG).all()
    i = np.sort(np.argsort(rng.random((b, npos)), 1)[:, :p], 1)
    d = rng.integers(1, 32768, (b, p))
    srt = torch.from_numpy(((i << 15) | d).astype(np.int32)).to(cuda)
    got = sortmatch.probe_span(x, n, srt, 12)
    _equal(got, sortmatch.probe_span_plain(x, n, srt, 12))


def _corpus_like(seed, nbytes):
    """Text-like bytes (a Zipf draw over a small vocabulary) around a
    stretch of noise."""
    rng = np.random.default_rng(seed)
    vocab = [rng.integers(97, 123, rng.integers(2, 10), dtype=np.uint8)
             .tobytes() for _ in range(400)]
    pick = np.minimum(rng.zipf(1.3, nbytes // 4), 400) - 1
    text = b" ".join(vocab[i] for i in pick)
    noise = rng.integers(0, 256, nbytes // 8, dtype=np.uint8).tobytes()
    return (text[:nbytes // 2] + noise + text[nbytes // 2:])[:nbytes]


def _parse_equal(comp, sbit, sout, span):
    """Both store forms of the parse kernel, one launch each, bitwise equal
    to their plain versions: JAX's step-major records (returned) and the
    decode's lane-major, clamped, padded rows."""
    before = _kernels.PARSE.launches
    got = decode2._parse_full(comp, sbit, sout, span)
    assert _kernels.PARSE.launches == before + 1
    _equal(got, decode2._parse_full_plain(comp, sbit, sout, span))
    flat = decode2._parse_flat(comp, sbit, sout, span)
    assert _kernels.PARSE.launches == before + 2
    _equal(flat, decode2._parse_flat_plain(comp, sbit, sout, span))
    return got


def test_parse_kernel_corpus_shape(cuda):
    """256 blocks of 32768 bytes encoded by the codec on the card: 146
    lanes, 264 substeps each; the lanes end where the next ones start."""
    block = 1 << 15
    data = _corpus_like(4, 256 * block)
    x, lens = pad_blocks(data, block)
    n = torch.from_numpy(lens).to(cuda)
    codec = BlockCodec(block=block, device=cuda)
    comp, _, sbit, sout, _ = codec.encode_batch(torch.from_numpy(x).to(cuda),
                                                n)
    assert comp.shape == (256, 36876) and sbit.shape == (256, 146)
    recs, final = _parse_equal(comp, sbit, sout, 2048)
    assert recs.shape == (256, 264, 146)
    nxt = torch.cat([sout[:, 1:] & 0x1FFFF, n[:, None]], dim=1)
    assert torch.equal(final, nxt)


@pytest.mark.parametrize("span,nslots,extra,shift", [
    (2048, 146, 0, 0), (2048, 5, -258, 0), (2048, 5, 41, 1),
    (160, 12, 13, 0), (160, 12, -7, 2), (2048, 1, 0, 0), (160, 1, 6, 3)])
def test_parse_kernel_corrupt_records(cuda, span, nslots, extra, shift):
    """Batch 33: half the rows with plausible records, half with any bit
    offset in [0, 8C] and any packed state (bit 31 set in some); byte rows
    longer or shorter than the lanes' words, odd lengths, and rows that
    start ``shift`` bytes past a 4-byte boundary."""
    b, c = 33, nslots * span // 8 + extra
    rng = np.random.default_rng(span + nslots + extra)
    comp = rng.integers(0, 256, b * c + shift, dtype=np.uint8)
    sbit = rng.integers(0, 8 * c + 1, (b, nslots))
    sbit[:16] = np.maximum(np.arange(nslots) * span
                           - rng.integers(0, 25, (16, nslots)), 0)
    sout = rng.integers(0, 1 << 31, (b, nslots), dtype=np.int64)
    sout[::5] |= 1 << 31
    sout = sout.astype(np.uint32).view(np.int32)
    comp_t = torch.from_numpy(comp).to(cuda)[shift:].view(b, c)
    recs, _ = _parse_equal(comp_t, torch.from_numpy(sbit.astype(np.int32))
                           .to(cuda), torch.from_numpy(sout).to(cuda), span)
    assert (recs >= 0).any() or nslots == 1


def test_container_256_blocks_on_card_equals_cpu(cuda):
    """A 256-block container: the card's bytes are the CPU's, and the card
    decodes it through the parse, fill and expand kernels, once each; a
    flipped payload byte raises ValueError."""
    data = _corpus_like(6, 256 * 2048 - 100)
    gpu = BlockCodec(block=2048, device=cuda)
    blob = gpu.compress(data)
    assert blob == BlockCodec(block=2048, device="cpu").compress(data)
    _kernels.reset_launches()
    assert gpu.decompress(blob) == data
    counts = _kernels.launch_counts()
    assert (counts["parse"], counts["rowscan_cummax"], counts["expand"]) == (
        1, 1, 1)
    mut = bytearray(blob)
    mut[len(mut) // 2] ^= 0x10
    with pytest.raises(ValueError):
        gpu.decompress(bytes(mut))


def _stage_kernels(events):
    """Device kernel names by the ``lzs::<stage>`` span open at their
    launch, from a profiler's Chrome trace events."""
    launch = {e["args"]["correlation"]: e["ts"] for e in events
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {})}
    spans = [(e["ts"], e["ts"] + e["dur"], e["name"][len("lzs::"):])
             for e in events if e.get("cat") == "user_annotation"
             and e.get("name", "").startswith("lzs::")]
    by_stage = {}
    for e in events:
        if e.get("cat") != "kernel":
            continue
        t = launch.get(e.get("args", {}).get("correlation"))
        stage = next((name for lo, hi, name in spans
                      if t is not None and lo <= t < hi), "other")
        by_stage.setdefault(stage, []).append(e["name"])
    return by_stage


def test_decode_fill_stage_runs_k8_alone(cuda, tmp_path):
    """A profiled decode_batch_sync at the container's shapes: the parse
    stage runs the parse kernel once, and the fill stage runs K8 and no
    other device kernel (the parse writes the fill's lane-major, clamped,
    padded rows itself)."""
    block = 1 << 15
    data = _corpus_like(8, 16 * block)
    x, lens = pad_blocks(data, block)
    n = torch.from_numpy(lens).to(cuda)
    codec = BlockCodec(block=block, device=cuda)
    comp, _, sbit, sout, _ = codec.encode_batch(torch.from_numpy(x).to(cuda),
                                                n)
    args = (comp, sbit, sout, n)
    decode2.decode_batch_sync(*args, out_cap=block)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        out, status = decode2.decode_batch_sync(*args, out_cap=block)
        torch.cuda.synchronize()
    path = tmp_path / "decode.json"
    prof.export_chrome_trace(str(path))
    by_stage = _stage_kernels(json.loads(path.read_text())["traceEvents"])
    assert len(by_stage["parse"]) == 1, by_stage
    assert "parse_lanes_kernel" in by_stage["parse"][0]
    assert len(by_stage["fill"]) == 1, by_stage
    (fill,) = by_stage["fill"]
    assert "chain_scan_kernel" in fill and "MaxOp" in fill
    assert "CopyIo" in fill
    assert not status.any()
    assert torch.equal(out[:, :block].cpu(), torch.from_numpy(x))


def test_probe_on_card_equals_cpu(cuda):
    """The wave-form probe on the card (gathers, rank, run columns) gives
    the CPU's run lengths, over two waves in one row."""
    rng = np.random.default_rng(12)
    npos = 4096
    x = rng.integers(0, 2, (8, npos)).astype(np.int32)
    x[0, 100:3000] = 9
    x[3, :] = np.tile(rng.integers(0, 256, 700), 6)[:npos]
    n = np.array([npos] * 4 + [npos - 100] * 4, np.int32)
    active = rng.random((8, npos)) < 0.4
    active[1] = True
    doff = np.minimum(rng.integers(1, 2048, (8, npos)),
                      np.arange(npos) + 1).astype(np.int32)
    doff[3] = np.minimum(700, np.arange(npos) + 1)
    args = [torch.from_numpy(a) for a in (x, n, doff, active)]
    want = sortmatch._probe_batch(*args, 12)
    _kernels.reset_launches()
    got = sortmatch._probe_batch(*(a.to(cuda) for a in args), 12)
    counts = _kernels.launch_counts()
    assert torch.equal(got.cpu(), want)
    assert int(want.max()) > 4 * 12
    assert counts["rank_mask"] == 4 and counts["probe_span"] == 4
    assert counts["gather_big"] > 4
    assert counts["rowscan_rcummin"] > 0


def _host_walk(step, n):
    starts = np.zeros(step.shape[0], bool)
    i = 0
    while i < n:
        starts[i] = True
        i += max(int(step[i]), 1)
    return starts


@pytest.mark.parametrize("b,npos,maxstep", [
    (3, 1, 4), (3, 129, 9), (4, 1000, 30), (33, 4096, 300),
    (2, 303104, 40)])
def test_walk_kernels(cuda, b, npos, maxstep):
    rng = np.random.default_rng(npos)
    step = rng.integers(-1, maxstep, (b, npos)).astype(np.int32)
    step[0, min(5, npos - 1)] = 1 << 30            # one huge step
    n = np.array([npos, 0, 1] + [npos - 3] * (b - 3), np.int32)[:b]
    st = torch.from_numpy(step).to(cuda)
    nt = torch.from_numpy(n).to(cuda)
    before = [k.launches for k in (_kernels.WALK_TABLES,
                                   _kernels.WALK_ENTRIES,
                                   _kernels.WALK_DESCENT)]
    got = pwalk.walk_starts(st, nt)
    assert [k.launches for k in (_kernels.WALK_TABLES, _kernels.WALK_ENTRIES,
                                 _kernels.WALK_DESCENT)] == [
        x + 1 for x in before]
    assert got.dtype == torch.bool and got.shape == (b, npos)
    m = -(-npos // 128) * 128
    padded = torch.cat([st, st.new_ones((b, m - npos))], dim=1)
    tabs, exits = pwalk.walk_tables(padded)
    _equal([tabs, exits], pwalk.walk_tables_plain(padded))
    entries = pwalk.walk_entries(exits)
    _equal([entries], [pwalk.walk_entries_plain(exits)])
    _equal([pwalk.walk_descent(tabs, entries, nt, npos)],
           [pwalk.walk_descent_plain(tabs, entries, nt, npos)])
    want = np.stack([_host_walk(step[i], n[i]) for i in range(b)])
    np.testing.assert_array_equal(got.cpu().numpy(), want)


@pytest.mark.parametrize("shift", [0, 1])
@pytest.mark.parametrize("b,ntiles", [(1, 6272), (300, 256), (3, 1),
                                      (33, 256), (4, 600), (2, 2369),
                                      (5, 1000)])
def test_walk_entries_kernel(cuda, b, ntiles, shift):
    """The seeded rows of tests/test_torch_walk.py: chains that skip a
    ring slot (16 tiles) and a whole ring (128 tiles), leave the row with
    a step of 2^30; the 2^18 row (1 x 6272 tiles), more rows than SMs, one
    tile, tile counts that are no multiple of a slot; exits 4 bytes past a
    16-byte boundary (shift: 4-byte copies)."""
    step = torch.from_numpy(walk_steps(ntiles, b, ntiles)).to(cuda)
    _, exits = pwalk.walk_tables_plain(step)
    if shift:
        exits = _misaligned(exits)
    want = pwalk.walk_entries_plain(exits)
    before = _kernels.WALK_ENTRIES.launches
    got = pwalk.walk_entries(exits)
    assert _kernels.WALK_ENTRIES.launches == before + 1
    _equal([got], [want])
    assert int(got[0, -1]) >= 1 << 30 or ntiles == 1
    if b > 1 and ntiles >= 500:
        assert int((got[1, 1:] - got[1, :-1]).max()) >= max(WALK_SKIPS) * 128


def _long_copy_fill(s, out_cap):
    """Literals, then copies whose sources lie many chunks back."""
    recs = [(k, 0, k % 251) for k in range(2000)] + [(2000, 1, 1999)]
    recs += [(out_cap // 2, 0, 65), (out_cap // 2 + 1, 1, 2047),
             (out_cap - 5000, 1, 3)]
    return hand_fill(recs, s, stride=2)


@pytest.mark.parametrize("rows", [3, 140])
@pytest.mark.parametrize("out_cap", [160 * 1024, 192 * 1024, 1 << 18])
def test_expand_kernel_wide_rows(cuda, out_cap, rows):
    """Rows in shared memory and past it, in fewer CTAs than SMs and in
    more (3 rows, 140 rows)."""
    s = 4096
    table = [(_long_copy_fill(s, out_cap), out_cap),
             (_long_copy_fill(s, out_cap), out_cap - 777),
             (hand_fill([(0, 0, 65), (1, 1, 1)], s), 1000)]
    table = (table * rows)[:rows]
    rec = torch.from_numpy(np.stack([r[0] for r in table])).to(cuda)
    n = torch.tensor([r[1] for r in table], dtype=torch.int32, device=cuda)
    got = _expand_equal(rec, n, out_cap)
    assert not got[1].any()
    row = got[0][0].cpu().numpy()        # the offset-1999 copy's period
    np.testing.assert_array_equal(row[2000:out_cap // 2],
                                  row[1:out_cap // 2 - 1999])


def test_raw_decode_on_card_equals_cpu(cuda):
    rng = np.random.default_rng(9)
    block = 2048
    data = (bytes(range(64)) * 30 + b"Q" * 1500
            + rng.integers(0, 256, 1800, dtype=np.uint8).tobytes()
            + b"the quick brown fox " * 120)[:5 * block - 300]
    cpu = BlockCodec(block=block, device="cpu")
    x, lens = pad_blocks(data, block)
    comp, clen, _, _, _ = cpu.encode_batch(torch.from_numpy(x),
                                           torch.from_numpy(lens))
    want = cpu.decode_batch_raw(comp, clen)
    gpu = BlockCodec(block=block, device=cuda)
    _kernels.reset_launches()
    got = gpu.decode_batch_raw(comp.to(cuda), clen.to(cuda))
    counts = _kernels.launch_counts()
    _equal([t.cpu() for t in got], want)
    for name in RAW_KERNELS:
        assert counts[name] > 0, name
    assert counts["rowscan_rcummin"] == 0
    chain = b"".join(comp[i, :clen[i]].numpy().tobytes()
                     for i in range(len(lens)))
    for multi in (False, True):
        assert (decode.decode_bytes(chain, 1 << 18, multi_stream=multi,
                                    device=cuda)
                == decode.decode_bytes(chain, 1 << 18, multi_stream=multi,
                                       device="cpu"))


def _heads_equal(comp, inbits, nbits, out_cap, multi=False, carry=None):
    """One ``bitpar._heads`` call on the card: one launch of the heads
    kernel and none of the chained scans, its four planes bitwise equal
    to ``_heads_plain`` on the same CUDA tensors."""
    args = (comp, inbits[:, None], nbits, out_cap, multi, carry)
    kernels = (_kernels.RAW_HEADS, _kernels.RCUMMIN, _kernels.CUMSUM)
    before = [k.launches for k in kernels]
    got = bitpar._heads(*args)
    assert [k.launches for k in kernels] == [before[0] + 1, *before[1:]]
    _equal(got, bitpar._heads_plain(*args))


@pytest.mark.parametrize("dtype", [torch.uint8, torch.int32])
@pytest.mark.parametrize("out_cap", [2048, 20])
@pytest.mark.parametrize("multi", [False, True])
def test_raw_heads_kernel_fuzz(cuda, multi, out_cap, dtype):
    """The raw fuzz batch at the width decode_batch_bits pads it to, both
    end-marker modes, an out_cap that clamps, int32 bytes too."""
    buf, lens = raw_fuzz(7)
    comp = torch.from_numpy(buf).to(cuda, dtype)
    _heads_equal(comp, torch.from_numpy(lens * 8).to(cuda),
                 8 * bitpar._padded(buf.shape[1]), out_cap, multi)


def test_raw_heads_kernel_burst(cuda):
    """A batch shaped like the IPComp burst: the codec's streams of 556-
    and 1480-byte payloads (4:1) in 2048-byte rows, zero past each."""
    lens = np.array([556, 556, 556, 556, 1480] * 8, np.int32)
    data = _corpus_like(21, int(lens.sum()))
    x = np.zeros((len(lens), 1500), np.uint8)
    at = np.concatenate([[0], np.cumsum(lens)])
    for row, s, n in zip(x, at, lens):
        row[:n] = np.frombuffer(data[s:s + n], np.uint8)
    codec = BlockCodec(block=1500, device=cuda)
    comp, clen, _, _, _ = codec.encode_batch(torch.from_numpy(x).to(cuda),
                                             torch.from_numpy(lens).to(cuda))
    rows = torch.zeros((len(lens), 2048), dtype=torch.uint8, device=cuda)
    width = min(comp.shape[1], 2048)
    rows[:, :width] = torch.where(
        torch.arange(width, device=cuda) < clen[:, None], comp[:, :width], 0)
    _heads_equal(rows, clen * 8, 8 * 2048, 1500)


@pytest.mark.parametrize("shift", [0, 1])
@pytest.mark.parametrize("multi", [False, True])
@pytest.mark.parametrize("width", [3 * 2048 + 1000, 40 * 2048 + 8])
def test_raw_heads_kernel_tiles(cuda, width, multi, shift):
    """Rows of several of the kernel's tiles, at span widths that are not
    a multiple of 1 KiB (as _window_loop passes): runs of 15-nibbles that
    end at, just before and just past tile boundaries, one across several
    tiles and a row of them (past 32 tiles: the look-back's next window
    of steps); input lengths inside a run and past the row; the rows 1
    byte past a 4-byte boundary where ``shift`` (byte loads); and the
    burst's row alone."""
    rows, inbits = heads_rows(width, width)
    flat = torch.zeros(rows.size + shift, dtype=torch.uint8, device=cuda)
    flat[shift:] = torch.from_numpy(rows.reshape(-1)).to(cuda)
    comp = flat[shift:].view(rows.shape)
    inbits = torch.from_numpy(inbits).to(cuda)
    _heads_equal(comp, inbits, 8 * width, bitpar._NO_CAP, multi)
    _heads_equal(comp[-2:-1], inbits[-2:-1], 8 * width, bitpar._NO_CAP,
                 multi)


@pytest.mark.parametrize("out_cap", [20, 1000])
def test_raw_heads_kernel_clamps(cuda, out_cap):
    """Lengths past out_cap (runs of 15-nibbles) clamp to it."""
    rows, inbits = heads_rows(3, 3 * 2048 + 1000)
    _heads_equal(torch.from_numpy(rows).to(cuda),
                 torch.from_numpy(inbits).to(cuda), 8 * rows.shape[1],
                 out_cap)


@pytest.mark.parametrize("width", [3 * 2048 + 1000, 40 * 2048 + 8])
def test_raw_heads_kernel_carry(cuda, width):
    """Continuation heads (carry) at first bits 0-7 with offsets 1 and
    2047, and rows with none (-1); every other row opens with a run of
    15-nibbles, so some continuations run on across tiles."""
    rows, inbits = heads_rows(5, width)
    rows[::2, :64] = 0xFF
    b = len(rows)
    bit = torch.arange(b, dtype=torch.int32, device=cuda) % 8
    offset = torch.tensor([(1, 2047, -1)[i % 3] for i in range(b)],
                          dtype=torch.int32, device=cuda)
    _heads_equal(torch.from_numpy(rows).to(cuda),
                 torch.from_numpy(inbits).to(cuda), 8 * width,
                 bitpar._NO_CAP, False, (bit, offset))
    _heads_equal(torch.from_numpy(rows).to(cuda),
                 torch.from_numpy(inbits).to(cuda), 8 * width, 300, True,
                 (bit, offset))


def _scan_streams(dev, shift):
    """Batch 33 of raw streams on the card: 12 blocks of the codec's own
    raw payload (2048-byte blocks), a truncation of each, two blocks
    concatenated, 8 rows of noise (corrupt streams); rows C bytes wide
    (C % 4 == 3 and a base 1 byte past a 4-byte boundary when
    ``shift``)."""
    block = 2048
    data = _corpus_like(11, 12 * block)
    codec = BlockCodec(block=block, device=dev)
    x, lens = pad_blocks(data, block)
    comp, clen, _, _, _ = codec.encode_batch(torch.from_numpy(x).to(dev),
                                             torch.from_numpy(lens).to(dev))
    rows = [comp[i, :int(clen[i])].cpu().numpy().tobytes()
            for i in range(len(lens))]
    rng = np.random.default_rng(5)
    streams = (rows + [r[:int(rng.integers(0, len(r)))] for r in rows]
               + [rows[0] + rows[1]]
               + [rng.integers(0, 256, 900, dtype=np.uint8).tobytes()
                  for _ in range(8)])
    c = max(len(r) for r in streams) + 5
    c += (3 - c % 4) % 4 if shift else (4 - c % 4) % 4
    buf = np.zeros((len(streams), c), np.uint8)
    for i, r in enumerate(streams):
        buf[i, :len(r)] = np.frombuffer(r, np.uint8)
    flat = torch.zeros(buf.size + shift, dtype=torch.uint8, device=dev)
    flat[shift:] = torch.from_numpy(buf.reshape(-1)).to(dev)
    n = torch.tensor([len(r) for r in streams], dtype=torch.int32,
                     device=dev)
    return flat[shift:].view(len(streams), c), n


def _scan_stores_equal(comp, n, **kw):
    """Both store forms of the scan parse kernel, one launch each, bitwise
    equal to their plain versions on the tensors' CPU copies (where a
    step's some 45 small torch calls cost a third of their launches on the
    card): JAX's step-major records (returned, on the card) and the
    decode's filled rows."""
    before = _kernels.SCAN_PARSE.launches
    got = decode._parse_scan(comp, n, **kw)
    filled = decode._parse_scan_filled(comp, n, **kw)
    assert _kernels.SCAN_PARSE.launches == before + 2
    want = decode._parse_scan_plain(comp.cpu(), n.cpu(), **kw)
    _equal([t.cpu() for t in got], want)
    _equal([t.cpu() for t in filled], [
        pext.cummax_rows_plain(decode2._flat_records(want[0][:, :, None])),
        *want[1:]])
    return got


@pytest.mark.parametrize("shift", [0, 1])
@pytest.mark.parametrize("max_units", [None, 300])
@pytest.mark.parametrize("multi", [False, True])
def test_scan_parse_kernel(cuda, multi, max_units, shift):
    """The scan parse (csrc/scan_parse.cu) at batch 33 against its plain
    loop on the same bytes: encoded blocks, truncations, two streams in a
    row, noise; the default budget and one that cuts; both stores (JAX's
    step records and the decode's filled rows), one launch each."""
    comp, n = _scan_streams(cuda, shift)
    assert len(n) == 33 and (comp.shape[1] % 4 == 3) == bool(shift)
    units = decode.default_max_units(8192) if max_units is None \
        else max_units
    got = _scan_stores_equal(comp, n, out_cap=8192, max_units=units,
                             multi_stream=multi)
    assert got[0].shape == (33, units)
    if max_units is None:
        assert int(got[2][24]) == (2 if multi else 1)


@pytest.mark.parametrize("shift", [0, 1])
def test_scan_parse_kernel_wide_rows(cuda, shift):
    """Rows wider than the kernel's 32 KiB shared-memory ring: the
    C-encoded 2^18 stream of the bench corpus (some 100 KB), once as it is
    and once with its input length 5000 bytes past the row (the bytes past
    C read as zero), in rows padded 3 bytes past the stream and (shift) 1
    byte past a 16-byte boundary; both stores against their plain loop."""
    from bench import make_corpus
    from lzs_tpu_torch.utils import native

    stream = native.compress(make_corpus(1 << 18)[:(1 << 18) - 1024])
    c = len(stream) + 3
    assert c > 32768
    buf = np.zeros((2, c), np.uint8)
    buf[:, :len(stream)] = np.frombuffer(stream, np.uint8)
    flat = torch.zeros(buf.size + shift, dtype=torch.uint8, device=cuda)
    flat[shift:] = torch.from_numpy(buf.reshape(-1)).to(cuda)
    comp = flat[shift:].view(2, c)
    n = torch.tensor([len(stream), c + 5000], dtype=torch.int32,
                     device=cuda)
    got = _scan_stores_equal(comp, n, out_cap=1 << 18,
                             max_units=decode.default_max_units(1 << 18),
                             multi_stream=False)
    assert got[1].tolist() == [(1 << 18) - 1024] * 2
    assert got[2].tolist() == [1, 1]


def test_scan_decode_on_card_equals_cpu(cuda):
    """decode_batch(engine="scan") on the card: the cpu's bytes, lengths
    and markers, engine "bits"'s too, through one launch each of the
    parse (its filled form) and the expansion (K17), and nothing else."""
    comp, n = _scan_streams(cuda, 0)
    for multi in (False, True):
        _kernels.reset_launches()
        got = decode.decode_batch(comp, n, out_cap=8192, multi_stream=multi,
                                  engine="scan")
        counts = _kernels.launch_counts()
        assert [counts[k] for k in ("scan_parse", "expand")] == [1, 1]
        assert sum(counts.values()) == 2
        want = decode.decode_batch(comp.cpu(), n.cpu(), out_cap=8192,
                                   multi_stream=multi, engine="scan")
        _equal([t.cpu() for t in got], want)
        _equal(got, decode.decode_batch(comp, n, out_cap=8192,
                                        multi_stream=multi))


@pytest.mark.parametrize("end_marker", [None, END])
@pytest.mark.parametrize("b,m", [(1, 1), (3, 1000), (2, 32768), (256, 32768),
                                 (1, 65536)])
def test_pack_kernel(cuda, end_marker, b, m):
    rng = np.random.default_rng(m)
    widths = np.array([0, 0, 4, 9, 11, 13, 17, 25])
    w = widths[rng.integers(0, len(widths), (b, m))].astype(np.int32)
    w[0, : m // 3] = 0
    v = (rng.integers(0, 1 << 25, (b, m)) & ((1 << w) - 1)).astype(np.int32)
    cap = (m * 25 // 8 + 16) & ~3
    vt, wt = torch.from_numpy(v).to(cuda), torch.from_numpy(w).to(cuda)
    _equal(ppack.pack_rows(vt, wt, cap, end_marker),
           ppack.pack_rows_plain(vt, wt, cap, end_marker))


@pytest.mark.parametrize("shift", [0, 1])
@pytest.mark.parametrize("end_marker", [None, END])
@pytest.mark.parametrize("b,m,live", [(6, 32768, 0.3), (5, 32767, 1.0),
                                      (2, 65536, 0.2), (256, 32768, 0.3),
                                      (1, 65536, 0.5), (7, 4099, 1.0)])
def test_pack_kernel_cases(cuda, end_marker, b, m, live, shift):
    """The seeded pack units (zero-width stretches over every 4096-unit
    segment edge, a zero segment and a zero row, totals that end a word or
    put the end marker across one) over clusters of 1 to 8 CTAs, at the
    encoder's 256 x 32768 and the packer's widest 65536 units, cap_bytes
    65536; rows 4 bytes past a 16-byte boundary (shift: scalar loads).
    One launch each."""
    v, w = (torch.from_numpy(a).to(cuda) for a in pack_units(m, b, m, live))
    if shift:
        v, w = _misaligned(v), _misaligned(w)
    before = _kernels.PACK.launches
    got = ppack.pack_rows(v, w, 1 << 16, end_marker)
    assert _kernels.PACK.launches == before + 1
    _equal(got, ppack.pack_rows_plain(v, w, 1 << 16, end_marker))
    assert int(got[1][0]) == (9 if end_marker else 0)


@pytest.mark.parametrize("cap", [8, 100, 4000])
def test_pack_kernel_past_cap(cuda, cap):
    """Streams longer than cap_bytes (widths 25 and 17, zero-width units
    between): windows whose first or second word lies past cap_bytes / 4
    are dropped, as the plain version drops them."""
    rng = np.random.default_rng(cap)
    w = rng.choice([0, 17, 25], (3, 20000)).astype(np.int32)
    v = (rng.integers(0, 1 << 25, w.shape) & ((1 << w) - 1)).astype(np.int32)
    vt, wt = torch.from_numpy(v).to(cuda), torch.from_numpy(w).to(cuda)
    for end_marker in (None, END):
        got = ppack.pack_rows(vt, wt, cap, end_marker)
        _equal(got, ppack.pack_rows_plain(vt, wt, cap, end_marker))
        assert (got[1] > 8 * cap).all()


def _units(dev, npos, datas, span):
    x = np.zeros((len(datas), npos), np.uint8)
    n = np.array([len(d) for d in datas], np.int32)
    for i, d in enumerate(datas):
        x[i, :len(d)] = np.frombuffer(d, np.uint8)
    xt = torch.from_numpy(x).to(dev)
    nt = torch.from_numpy(n).to(dev)
    _, _, total, offs, width, starts, off = encode._pipeline_batch(
        xt, nt, 2047, 12)
    nslots = encode.sync_slots(npos, span)
    return (starts, width, off, offs, total - 9, nt), dict(
        span=span, nibbles=6, short_len=8, ext_len=15, nslots=nslots)


@pytest.mark.parametrize("span", [96, 288, 2048])
def test_sync_kernel(cuda, span):
    """Bool starts as the encoder gives them, and int32 and uint8 rows."""
    rng = np.random.default_rng(span)
    datas = [bytes(range(64)), b"Z" * 500 + b"the quick brown fox " * 25,
             rng.integers(0, 256, 1024, dtype=np.uint8).tobytes(), b""]
    args, kw = _units(cuda, 1024, datas, span)
    want = psync.sync_records_plain(*args, **kw)
    for dtype in (torch.bool, torch.int32, torch.uint8):
        _equal(psync.sync_records(args[0].to(dtype), *args[1:], **kw), want)


def _misaligned(t):
    """A contiguous copy of ``t`` whose data starts 4 bytes past a 16-byte
    boundary (the kernel's scalar loads)."""
    flat = torch.zeros(t.numel() + 4, dtype=t.dtype, device=t.device)
    flat[4 // t.element_size():][:t.numel()] = t.flatten()
    return flat[4 // t.element_size():][:t.numel()].view(t.shape)


@pytest.mark.parametrize("npos,span", [(1, 128), (96, 96), (8193, 288),
                                       (32768, 2048), (32768, 160)])
def test_sync_kernel_edge_rows(cuda, npos, span):
    """Batch 33 of generated unit rows (nibble chains across the 8192-
    position CTAs of a row's cluster, offsets above 0xFFF, end_bits a
    multiple of the span, empty and short rows), as 16-aligned rows and
    as unaligned ones."""
    arrays = [torch.from_numpy(a).to(cuda)
              for a in sync_batch(npos, 33, npos, span)]
    kw = sync_kwargs(npos, span)
    want = psync.sync_records_plain(*arrays, **kw)
    before = _kernels.SYNC.launches
    _equal(psync.sync_records(*arrays, **kw), want)
    _equal(psync.sync_records(*(_misaligned(a) if a.dim() == 2 else a
                                for a in arrays), **kw), want)
    assert _kernels.SYNC.launches == before + 2
    assert (want[0][:, 1:] > 0).any() or npos == 1


#: test_sync_launches_no_conversion's profile, run in a fresh process
_SYNC_PROFILE = """
import json, sys
import torch
sys.path.insert(0, sys.argv[1])
from test_torch_cases import sync_batch, sync_kwargs
from lzs_tpu_torch.ops import psync
cuda = torch.device("cuda", 0)
arrays = [torch.from_numpy(a).to(cuda) for a in sync_batch(7, 33, 32768, 2048)]
kw = sync_kwargs(32768, 2048)
psync.sync_records(*arrays, **kw)
torch.cuda.synchronize()
acts = [torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA]
with torch.profiler.profile(activities=acts) as prof:
    psync.sync_records(*arrays, **kw)
    torch.cuda.synchronize()
print(json.dumps([e.name for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]))
"""


def test_sync_launches_no_conversion(cuda):
    """The encoder's bool starts go to the kernel as they are: the call
    launches one kernel, the sync kernel, and nothing else. The profile
    runs in a fresh process: in one that has profiled before, a later
    torch.profiler session can see no device events at all (on the H100,
    with no port code: one session, ten seconds of small launches, then
    every session empty), which the tests before this one can cause."""
    tests = pathlib.Path(__file__).resolve().parent
    run = subprocess.run([sys.executable, "-c", _SYNC_PROFILE, str(tests)],
                         cwd=tests.parent, capture_output=True, text=True,
                         timeout=600)
    assert run.returncode == 0, run.stderr[-4000:]
    kernels = json.loads(run.stdout.strip().splitlines()[-1])
    assert len(kernels) == 1 and "sync_kernel" in kernels[0], kernels


def _expand_equal(rec, n, out_cap):
    before = _kernels.EXPAND.launches
    got = pexpand.expand_records(rec, n, out_cap)
    assert _kernels.EXPAND.launches == before + 1
    _equal(got, pexpand.expand_records_plain(rec, n, out_cap))
    return got


@pytest.mark.parametrize("slots", [768, None])
@pytest.mark.parametrize("out_cap", [1000, 32767])
def test_expand_kernel_edge_rows(cuda, out_cap, slots):
    """The generated rows (one record over many chunks, copy chains up to
    chunk boundaries, the widest record windows at span 160, 768 slots,
    status 2 and 3) as a batch of fewer rows than SMs and of more."""
    rec, n = expand_batch(out_cap, out_cap, slots)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    reps = -(-(sms + 1) // len(n))
    for r, m in ((rec, n), (np.tile(rec, (reps, 1)), np.tile(n, reps))):
        got = _expand_equal(torch.from_numpy(r).to(cuda),
                            torch.from_numpy(m).to(cuda), out_cap)
        assert {0, 2, 3} <= set(got[1].tolist())


@pytest.mark.parametrize("out_cap", [1000, 4096])
def test_expand_kernel_status_rows(cuda, out_cap):
    s = 6144
    table = [
        (hand_fill([(0, 0, 81), (1, 1, 1)], s), 4000),
        (hand_fill([(k, 0, k % 251) for k in range(1999)]
                    + [(1999, 1, 1999)], s, stride=1), 4096),
        (hand_fill([(0, 0, 65), (1, 1, 5), (9, 0, 66)], s), 100),
        (hand_fill([(3, 0, 65), (4, 1, 1)], s), 50),
        (hand_fill([(3, 0, 65), (4, 1, 9)], s), 50),
        (hand_fill([(0, 0, 65)], s), 0),
    ]
    rec = torch.from_numpy(np.stack([t[0] for t in table])).to(cuda)
    n = torch.tensor([t[1] for t in table], dtype=torch.int32, device=cuda)
    got = pexpand.expand_records(rec, n, out_cap)
    _equal(got, pexpand.expand_records_plain(rec, n, out_cap))
    assert got[1].tolist() == [0, 0, 2, 3, 3, 0]


def test_codec_on_card_equals_cpu(cuda):
    """Both policies' containers on the card are the CPU's and round-trip;
    the greedy raw payload is the C encoder's bytes block by block, and
    the C decoder reads it back; a second compress at 32 KiB blocks gives
    the first one's bytes."""
    from lzs_tpu_torch.utils import native

    rng = np.random.default_rng(5)
    lits = [c for c in range(256) if c not in (65, 66)]
    deep = b"".join(bytes([lits[k % len(lits)], 65, 66])
                    for k in range(1300))[:3900]
    data = (deep + b"Q" * 3000 + rng.integers(0, 256, 2000, dtype=np.uint8)
            .tobytes() + bytes(range(64)) * 20)
    for policy in ("greedy", "lazy"):
        gpu = BlockCodec(block=2048, policy=policy, device=cuda)
        cpu = BlockCodec(block=2048, policy=policy, device="cpu")
        _kernels.reset_launches()
        blob = gpu.compress(data)
        counts = _kernels.launch_counts()
        assert {k: counts[k] for k in ("perk_level", "ext_breaks",
                                       "ext_fold", "walk_descent",
                                       "pack")} == {
            "perk_level": 11, "ext_breaks": 1, "ext_fold": 1,
            "walk_descent": 1, "pack": 1}
        assert blob == cpu.compress(data)
        assert gpu.decompress(blob) == data
        assert gpu.compress(b"") == cpu.compress(b"")
        assert gpu.decompress(gpu.compress(b"x")) == b"x"
    raw = BlockCodec(block=2048, device=cuda).compress(data, container=False)
    assert raw == b"".join(native.compress(data[s:s + 2048])
                           for s in range(0, len(data), 2048))
    assert native.decompress(raw, out_cap=len(data),
                             multi_stream=True) == data
    # a second compress with the same codec gives the same bytes: nothing
    # of one call (a reused buffer, a cached plan) leaks into the next
    wide = BlockCodec(block=32768, device=cuda)
    text = _corpus_like(7, 3 * 32768 - 500)
    blob = wide.compress(text)
    assert wide.compress(text) == blob and wide.decompress(blob) == text


def test_wrappers_reject_bad_operands(cuda):
    v = torch.zeros((4, 64), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        pext.cummax_rows(v[:, ::2])
    with pytest.raises(TypeError):
        pext.cummax_rows(v.to(torch.int64))
    with pytest.raises(ValueError):
        pext.cummax_rows(v[0])
    with pytest.raises(ValueError):
        ppack.pack_rows(v, v.cpu(), 64)
    with pytest.raises(ValueError, match="no units"):
        ppack.pack_rows(v[:, :0], v[:, :0], 64)
    wide = torch.zeros((1, ppack.MAX_UNITS + 1), dtype=torch.int32,
                       device=cuda)
    with pytest.raises(ValueError, match="at most"):
        ppack.pack_rows(wide, wide, 64)
    with pytest.raises(ValueError, match="multiple of 4"):
        ppack.pack_rows(v, v, 62)
    with pytest.raises(ValueError):
        pexpand.expand_records(v, v[:, 0].contiguous(), 1 << 20)
    with pytest.raises(ValueError, match="multiple of 128"):
        pwalk.walk_tables(v[:, :63].contiguous())
    with pytest.raises(ValueError):
        pwalk.walk_entries(v)
    with pytest.raises(TypeError):
        pext.cumsum_rows_wide(v.to(torch.int64))
    n = torch.full((4,), 64, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        pcand.perk_level(v, v[:, :32].contiguous(), n, v, 2, 64)
    with pytest.raises(TypeError):
        pcand.perk_level(v.to(torch.int64), v, n, v, 2, 64)
    with pytest.raises(TypeError):
        pcand.perk_level(v, v, n, v.to(torch.int64), 2, 64)
    with pytest.raises(ValueError):
        pcand.perk_level(v, v, n[:3].contiguous(), v, 2, 64)
    with pytest.raises(ValueError):
        pcand.perk_level(v, v, n, v[:, ::2], 2, 64)
    with pytest.raises(ValueError):
        pcand.perk_level(v, v.cpu(), n, v, 2, 64)
    with pytest.raises(ValueError):
        pext.ext_breaks(v, v[:, ::2], n, 12)
    with pytest.raises(TypeError):
        pext.ext_breaks(v, v, n.to(torch.int64), 12)
    with pytest.raises(ValueError):
        pext.ext_fold(v, v[:2].contiguous(), v, 12)
    with pytest.raises(TypeError):
        pext.ext_fold(v, v, v.to(torch.int16), 12)
    with pytest.raises(TypeError):
        pext.rank_mask(v)
    with pytest.raises(ValueError):
        pext.rank_mask((v > 0)[:, ::2])
    with pytest.raises(TypeError):
        sortmatch.probe_span(v, n, v.to(torch.int64), 12)
    with pytest.raises(ValueError):
        sortmatch.probe_span(v, n[:3].contiguous(), v, 12)
    with pytest.raises(ValueError):
        sortmatch.probe_span(v, n, v[:3].contiguous(), 12)
    with pytest.raises(ValueError):
        sortmatch.probe_span(v, n, v.cpu(), 12)
    with pytest.raises(TypeError):
        pgather.gather_big(v, v.to(torch.int64))
    with pytest.raises(ValueError):
        pgather.gather_big(v, v[:, ::2])
    with pytest.raises(ValueError):
        pgather.gather_big(v, v[:3].contiguous())
    comp = torch.zeros((4, 64), dtype=torch.uint8, device=cuda)
    with pytest.raises(TypeError):
        decode2._parse_full(comp.to(torch.int32), v, v, 160)
    with pytest.raises(ValueError):
        decode2._parse_full(comp, v, v[:, ::2], 160)
    with pytest.raises(ValueError):
        decode2._parse_full(comp[:3], v, v, 160)
    with pytest.raises(ValueError):
        decode2._parse_full(comp, v, v.cpu(), 160)
    with pytest.raises(TypeError):
        decode._parse_scan(comp.to(torch.int32), n, out_cap=64,
                           max_units=8)
    with pytest.raises(ValueError):
        decode._parse_scan(comp, n[:3].contiguous(), out_cap=64,
                           max_units=8)
    with pytest.raises(ValueError):
        decode._parse_scan(comp[:, ::2], n, out_cap=64, max_units=8)
    with pytest.raises(ValueError):
        decode._parse_scan(comp, n.cpu(), out_cap=64, max_units=8)
    with pytest.raises(TypeError):
        decode._parse_scan_filled(comp.to(torch.int32), n, out_cap=64,
                                  max_units=8)
    with pytest.raises(ValueError):
        decode._parse_scan_filled(comp[:, ::2], n, out_cap=64, max_units=8)
    with pytest.raises(TypeError):
        decode2._parse_flat(comp.to(torch.int32), v, v, 160)
    with pytest.raises(ValueError):
        decode2._parse_flat(comp, v, v[:, ::2], 160)


# --- the streaming codec's kernels at batch 1 ---------------------------

#: the match search's kernel wrappers and their plain versions
_SEARCH_KERNELS = {
    "gram_keys": (sortmatch, "gram_keys", sortmatch.gram_keys_plain),
    "rank_lcp": (sortmatch, "rank_lcp", sortmatch.rank_lcp_plain),
    "perk_level": (pcand, "perk_level", pcand.perk_level_plain),
    "ext_breaks": (pext, "ext_breaks", pext.ext_breaks_plain),
    "ext_fold": (pext, "ext_fold", pext.ext_fold_plain),
    "rank_mask": (pext, "rank_mask", pext.rank_mask_plain),
    "probe_span": (sortmatch, "probe_span", sortmatch.probe_span_plain),
    "gather_big": (pgather, "gather_big", pgather.gather_big_plain),
    "rcummin_rows": (pext, "rcummin_rows", pext.rcummin_rows_plain),
}


def _record_search(monkeypatch):
    """Record every call of the match search's kernel wrappers."""
    calls = []
    for name, (module, attr, _) in _SEARCH_KERNELS.items():
        wrapper = getattr(module, attr)

        def record(*args, _name=name, _wrapper=wrapper, **kw):
            calls.append((_name, args, kw))
            return _wrapper(*args, **kw)

        monkeypatch.setattr(module, attr, record)
    return calls


def _check_recorded(calls):
    """Each recorded kernel call equals its plain version, bitwise."""
    for name, args, kw in calls:
        module, attr, plain = _SEARCH_KERNELS[name]
        got = getattr(module, attr)(*args, **kw)
        want = plain(*args, **kw)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        _equal(got, want)


@pytest.mark.parametrize("backend", ["sort", "exhaustive"])
@pytest.mark.parametrize("pool", [256 << k for k in range(8)])
def test_stream_search_kernels_at_batch_1(cuda, monkeypatch, pool, backend):
    """Both backends' match search at batch 1 and each pool of the stream,
    n at the pool and below it: every kernel call equals its plain
    version, and the tables equal the CPU's."""
    from lzs_tpu_torch import stream

    rng = np.random.default_rng(pool)
    arr = np.tile(rng.integers(0, 256, 300), pool // 300 + 1)[:pool]
    arr[rng.random(pool) < 0.05] = 7
    arr = arr.astype(np.int32)
    for n in (pool, pool * 3 // 4 + 1):
        calls = _record_search(monkeypatch)
        got = stream._best_matches_host(arr, n, backend=backend, device=cuda)
        monkeypatch.undo()
        names = {c[0] for c in calls}
        if backend == "sort":
            assert {"gram_keys", "rank_lcp", "perk_level", "ext_breaks",
                    "ext_fold"} <= names
        else:
            assert names == {"rcummin_rows"}
        _check_recorded(calls)
        want = stream._best_matches_host(arr, n, backend=backend,
                                         device="cpu")
        for g, w in zip(got, want, strict=True):
            np.testing.assert_array_equal(g, w)


def test_exhaustive_plane_k7_rows(cuda, monkeypatch):
    """The exhaustive plane's reverse cummin runs on K7 over (B * dc, N)
    rows (at batch 33, 256 offsets a chunk): each launch equals the plain
    scan, and the tables equal the CPU's."""
    from lzs_tpu_torch.ops import match

    rng = np.random.default_rng(3)
    x = np.repeat(rng.integers(0, 4, (33, 700)), 3, axis=1)[:, :2048]
    x = torch.from_numpy(x.astype(np.int32))
    n = torch.from_numpy(rng.integers(1, 2049, 33).astype(np.int32))
    calls = _record_search(monkeypatch)
    got = match.best_matches_batch(x.to(cuda), n.to(cuda))
    monkeypatch.undo()
    assert len(calls) == 8
    assert {tuple(c[1][0].shape) for c in calls} == {(33 * 256, 2048)}
    _check_recorded(calls)
    _equal([g.cpu() for g in got], match.best_matches_batch(x, n))


@pytest.mark.parametrize("backend", ["sort", "exhaustive"])
def test_stream_on_card_equals_cpu(cuda, backend):
    """The first 256 KiB of the bench corpus streamed on the card equal
    the same stream on the CPU and the C encoder's one-shot bytes."""
    from bench import make_corpus
    from lzs_tpu_torch import stream
    from lzs_tpu_torch.utils import native

    data = make_corpus(1 << 18)

    def run(device):
        c = stream.StreamCompressor(backend=backend, device=str(device))
        out = bytearray()
        for ofs in range(0, len(data), 1 << 16):
            out += c.feed(data[ofs:ofs + (1 << 16)])
        return bytes(out + c.finish())

    _kernels.reset_launches()
    got = run(cuda)
    counts = _kernels.launch_counts()
    if backend == "sort":
        assert counts["perk_level"] > 0 and counts["ext_fold"] > 0
    else:
        assert counts["rowscan_rcummin"] > 0 and counts["perk_level"] == 0
    assert got == run("cpu") == native.compress(data)
    assert stream.decompress_stream(got) == data


def test_profile_tables_card_equals_cpu(cuda):
    """The codec profiles' match search on the card: each distinct
    (window, cap) table over 32768 bytes of the bench corpus equals the
    CPU's, and the far-offset repeat inputs give the CPU's tokens."""
    from bench import make_corpus
    from lzs_tpu_torch import stream
    from lzs_tpu_torch.models import PROFILES, get_profile

    data = make_corpus(1 << 15)
    arr = np.frombuffer(data, np.uint8).astype(np.int32)
    pairs = sorted({(c.window, c.search_cap) for c in PROFILES.values()})
    assert pairs == [(2047, 12), (2174, 12), (4095, 12)]
    for window, cap in pairs:
        got, want = (stream._best_matches_host(arr, len(data), window=window,
                                               cap=cap, device=dev)
                     for dev in (cuda, "cpu"))
        for g, w in zip(got, want, strict=True):
            np.testing.assert_array_equal(g, w)
    rng = np.random.default_rng(0)
    for period in (2100, 3000):
        block = rng.integers(0, 256, period, dtype=np.uint8).tobytes() * 2
        for name in ("reach", "flat", "bounded"):
            toks = get_profile(name).compress(block)
            assert toks == get_profile(name, device="cpu").compress(block)
            assert get_profile(name).decompress(toks) == block


def test_wide_raw_decode_on_card(cuda):
    """Engine "bits" past 2^18 output bytes on the card, in windows: 1 MiB
    of the bench corpus as one C-encoded stream at out_cap 2^20, and 1
    MiB of zeros (copies that run across windows) at 2^21, as a batch of
    both rows, equal the CPU's decode (bytes, lengths, end markers) and
    the inputs; the windows launch the fill and the expansion."""
    from bench import make_corpus
    from lzs_tpu_torch.ops import decode
    from lzs_tpu_torch.utils import native

    datas = [make_corpus(1 << 20), bytes(1 << 20)]
    streams = [native.compress(d) for d in datas]
    buf = np.zeros((2, max(map(len, streams))), np.uint8)
    for i, st in enumerate(streams):
        buf[i, :len(st)] = np.frombuffer(st, np.uint8)
    lens = torch.tensor([len(st) for st in streams], dtype=torch.int32)
    _kernels.reset_launches()
    got = decode.decode_batch(torch.from_numpy(buf).to(cuda), lens.to(cuda),
                              out_cap=1 << 21, multi_stream=True)
    counts = _kernels.launch_counts()
    assert counts["rowscan_cummax"] > 8 and counts["expand"] > 8
    want = decode.decode_batch(torch.from_numpy(buf), lens, out_cap=1 << 21,
                               multi_stream=True)
    for g, w in zip(got, want, strict=True):
        assert torch.equal(g.cpu(), w)
    for i, d in enumerate(datas):
        assert want[0][i, :int(want[1][i])].numpy().tobytes() == d


def test_cli_raw_decode_takes_the_device_route(cuda, tmp_path):
    """The CLI's raw decode on the card (its default device): four blocks
    of the bench corpus (a ~53 KB stream), and sixteen blocks (past 2^18
    output bytes, which JAX's CLI decodes on the host, expanded in
    windows of 2^18), through the raw decoder's kernels."""
    import contextlib
    import io

    from bench import make_corpus
    from lzs_tpu_torch import cli
    from lzs_tpu_torch.utils import native

    data = make_corpus(1 << 19)
    for size in (1 << 17, 1 << 19):
        src, out = tmp_path / f"{size}.lzs", tmp_path / f"{size}.out"
        src.write_bytes(b"".join(native.compress(data[s:s + (1 << 15)])
                                 for s in range(0, size, 1 << 15)))
        err = io.StringIO()
        _kernels.reset_launches()
        with contextlib.redirect_stderr(err):
            assert cli.main(["decompress", "-v", str(src), str(out)]) == 0
        counts = _kernels.launch_counts()
        assert out.read_bytes() == data[:size]
        assert "route: device\n" in err.getvalue()
        assert counts["walk_tables"] > 0 and counts["expand"] > 0


def test_raw_file_past_2_25_on_card(cuda, tmp_path):
    """A raw file past 2^25 bytes of input (the C encoder's blocks of the
    8 MiB bench corpus, repeated: some 37 MiB) decodes on the card to
    its input through decode_bytes (multi-stream, out_cap the output)
    and through cli.main, over windows of the input that launch the
    heads kernel, the walk (K11-K13), the chained scans (K8, K9) and the
    expansion (K17)."""
    import contextlib
    import io

    from bench import make_corpus
    from lzs_tpu_torch import cli
    from lzs_tpu_torch.ops import bitpar
    from lzs_tpu_torch.utils import native

    data = make_corpus(1 << 23)
    raw = b"".join(native.compress(data[s:s + (1 << 15)])
                   for s in range(0, len(data), 1 << 15))
    reps = (1 << 25) // len(raw) + 1
    chain, want = raw * reps, data * reps
    assert len(chain) > 1 << 25 > 2 * bitpar._WIN
    _kernels.reset_launches()
    assert decode.decode_bytes(chain, len(want), multi_stream=True) == want
    counts = _kernels.launch_counts()
    for name in ("walk_tables", "walk_entries", "walk_descent",
                 "raw_heads", "rowscan_cumsum", "rowscan_cummax"):
        assert counts[name] >= 2, (name, counts[name])
    assert counts["expand"] > len(want) >> 18
    src, out = tmp_path / "big.lzs", tmp_path / "big.out"
    src.write_bytes(chain)
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        assert cli.main(["decompress", "-v", str(src), str(out)]) == 0
    assert out.read_bytes() == want
    assert "route: device\n" in err.getvalue()


def long_token_file(nibbles: int) -> tuple[bytes, int]:
    """A raw file of one long token, and the a's it decodes to (then one
    b): a literal a, a copy of offset 1 with length code 1111,
    ``nibbles`` extension nibbles of 15 and the end nibble 3, a literal b
    and an end marker, bit by bit at its ends and 0xff bytes between. Its
    token is 8 + 15 * nibbles + 3 bytes, each the one before it."""
    head = "0" + format(ord("a"), "08b") + "11" + "0000001" + "1111"
    fill = -len(head) % 8
    whole, rest = divmod(4 * nibbles - fill, 8)
    end = "1" * rest + "0011" + "0" + format(ord("b"), "08b") + "110000000"
    end += "0" * (-len(end) % 8)

    def pack(bits: str) -> bytes:
        return int(bits, 2).to_bytes(len(bits) // 8, "big")

    data = (pack(head + "1" * fill) + np.full(whole, 0xFF, np.uint8).tobytes()
            + pack(end))
    return data, 1 + 8 + 15 * nibbles + 3


def test_long_token_on_card(cuda, tmp_path):
    """A raw file of one copy of offset 1 whose run of 15-nibbles spans
    some 2.5 input windows (5 * 2^23 nibbles: 20 MiB in, 629 MB out)
    decodes on the card through cli.main, each window cutting the run,
    and through decode_batch_bits at an out_cap inside the token: the
    copy rule's bytes, over windows that launch the heads kernel, the walk
    (K11-K13), the chained scans (K8, K9) and the expansion (K17). A run
    of 2^27 + 2^24 nibbles (its run past 2^26 input bytes, 2,264,924,173
    bytes out, past 2^31) decodes through the CLI's raw route too."""
    import contextlib
    import io

    from lzs_tpu_torch import cli
    from lzs_tpu_torch.ops import bitpar

    data, n = long_token_file(5 << 23)
    assert len(data) > 2 * bitpar._WIN + bitpar._MARGIN
    src, out = tmp_path / "long.lzs", tmp_path / "long.out"
    src.write_bytes(data)
    err = io.StringIO()
    _kernels.reset_launches()
    with contextlib.redirect_stderr(err):
        assert cli.main(["decompress", "-v", str(src), str(out)]) == 0
    counts = _kernels.launch_counts()
    assert out.read_bytes() == b"a" * n + b"b"
    assert "route: device\n" in err.getvalue()
    for name in RAW_KERNELS:
        assert counts[name] >= 1, (name, counts[name])
    assert counts["walk_entries"] >= 3
    cap = 1 << 29
    assert cap < n
    comp = torch.from_numpy(np.frombuffer(data, np.uint8).copy()).to(cuda)
    got, out_len, markers = bitpar.decode_batch_bits(
        comp[None], torch.tensor([len(data)], dtype=torch.int32,
                                 device=cuda), out_cap=cap)
    assert got.shape == (1, cap) and bool((got == ord("a")).all())
    assert out_len.tolist() == [cap] and markers.tolist() == [0]
    del comp, got
    data, n = long_token_file((1 << 27) + (1 << 24))
    assert n + 1 > 1 << 31 and len(data) > 1 << 26
    _kernels.reset_launches()
    out = cli._decompress_raw_device(data, cuda)
    counts = _kernels.launch_counts()
    assert len(out) == n + 1 and out[-1:] == b"b" and out.count(b"a") == n
    for name in RAW_KERNELS:
        assert counts[name] >= 1, (name, counts[name])


def test_distributed_codec_nccl_world_of_one(cuda, tmp_path):
    """DistributedCodec on an NCCL world of one equals BlockCodec on the
    card (payload and sync arrays) and round-trips."""
    import torch.distributed as dist

    from bench import make_corpus
    from lzs_tpu_torch import parallel

    data = make_corpus(5 * 32768 + 100)
    parallel.initialize_distributed(f"file://{tmp_path}/store", 1, 0)
    try:
        codec = parallel.DistributedCodec(parallel.make_block_mesh(),
                                          block=32768)
        payload, clens, sbit, sout, nsync = codec.compress(data)
        lens = pad_blocks(data, 32768)[1]
        assert codec.decompress(payload, clens, sbit, sout, lens) == data
    finally:
        dist.destroy_process_group()
    ref = BlockCodec(block=32768, device=cuda)
    assert payload == ref.compress(data, container=False)
    x = torch.from_numpy(pad_blocks(data, 32768)[0]).to(cuda)
    want = ref.encode_batch(x, torch.from_numpy(lens).to(cuda))
    for got, w in zip((np.asarray(clens), sbit, sout, nsync), want[1:],
                      strict=True):
        np.testing.assert_array_equal(got, w.cpu().numpy())


def test_session_codec_on_card_equals_cpu(cuda):
    packets = _plan(5, 33, 7)
    gpu = SessionCodec(33, device=cuda)
    cpu = SessionCodec(33, device="cpu")
    for c, row in enumerate(packets):
        if c == 4:
            gpu.reset([0, 7])
            cpu.reset([0, 7])
        x, n = _batch(row)
        comp, nbytes = gpu.compress(x.to(cuda), n.to(cuda))
        want, wbytes = cpu.compress(x, n)
        assert torch.equal(nbytes.cpu(), wbytes)
        assert torch.equal(comp.cpu(), want)
        assert torch.equal(gpu.hlen.cpu(), cpu.hlen)
        assert torch.equal(gpu.hist.cpu(), cpu.hist)


def test_encode_start_zero_launches_the_same(cuda):
    rng = np.random.default_rng(21)
    x, n = _batch([_text(rng, int(k)) for k in rng.integers(0, 3548, 33)],
                  3547)
    x, n = x.to(cuda), n.to(cuda)
    out, counts = [], []
    for start in (None, torch.zeros(33, dtype=torch.int32, device=cuda)):
        _kernels.reset_launches()
        out.append(encode.encode_batch(x, n, start=start))
        counts.append(_kernels.launch_counts())
    assert counts[0] == counts[1] and counts[0]["walk_descent"] == 1
    assert torch.equal(out[0][0], out[1][0])
    assert torch.equal(out[0][1], out[1][1])


# --- each path launches its kernels -------------------------------------

#: chip_smoke's sizes cut so that each path runs in seconds and still
#: reaches all of its kernels: 2048-byte blocks of ``_runs_data`` (runs
#: past the probe's 48-byte span, so probe waves and a tier-2 round run),
#: a step budget that cuts every 2048-byte stream, the big raw file one
#: copy of the raw file
SMALL = {"BLOCK": 2048, "CUT_UNITS": 60, "BIG_MIB": 0}


@pytest.mark.parametrize("path", list(PATH_KERNELS))
def test_path_launches_its_kernels(cuda, tmp_path, monkeypatch, path):
    """Each path of the port on the card, driven by ``chip_smoke.DRIVES``
    at ``SMALL`` sizes, launches every kernel of ``PATH_KERNELS[path]``
    and no other, the counters reset after its inputs are made, and a
    match search (main, stream) launches perk_level 11 times and
    gram_keys, rank_lcp, ext_breaks and ext_fold once
    (``chip_smoke.check_launches``); its outputs are checked as it runs
    (the C encoder's bytes, round trips, status words)."""
    for name, value in SMALL.items():
        monkeypatch.setattr(chip_smoke, name, value)
    run = chip_smoke.DRIVES[path](_runs_data(), cuda, tmp_path)
    torch.cuda.synchronize()
    _kernels.reset_launches()
    run()
    counts = _kernels.launch_counts()
    check_launches(path, counts)
    if path == "main":                     # two compresses, a search each
        assert counts["gram_keys"] == 2 and counts["perk_level"] == 22


def test_every_kernel_is_on_a_path():
    """Every kernel of the library is on some path's list."""
    assert set(chip_smoke.DRIVES) == set(PATH_KERNELS)
    assert ({k for names in PATH_KERNELS.values() for k in names}
            == {k.name for k in _kernels.KERNELS})
