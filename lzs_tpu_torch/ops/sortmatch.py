"""Sort-based LZS match search, batched over blocks.

Port of ``lzs_tpu.ops.sortmatch`` in the form the JAX package runs on its
accelerator: ``candidates_batch`` sorts the grams and runs the per-k glue
of ``pcand`` (K1, a row sort and K2+K3, one kernel per level) and
``_extend_batch`` the extension scans of ``pext`` (K4, the probe tier,
K5); the probe tier compacts its lanes into waves and runs on
``probe_span`` (``csrc/probe.cu``, tier 1), ``pgather.gather_big``
(K10), ``pext.rcummin_rows`` (K7) and ``pext.rank_mask`` (K6). Each
kernel stage launches a CUDA kernel on a CUDA tensor. Per position i of
each block:

  score[i] = max k in [2, cap] such that the k-gram at i occurs at some
             j in [i - window, i - 1]             (capped greedy score)
  off[i]   = i - j* where j* is the nearest such occurrence for k = score
  full[i]  = exact run length of the chosen offset (= score when < cap)

The policy is byte-identical to the reference C encoders
(lzs-compression.c:326-362); see ``lzs_tpu.ops.sortmatch`` for the
derivation of every step. What differs here:

  * The 12-byte gram sort is two stable one-key sorts (torch.sort takes
    one key), the last 4 bytes first, on packed keys that ``gram_keys``
    (``csrc/gram.cu``) builds with their sign bits flipped, since torch
    has no unsigned sort; ``rank_lcp`` (the same file) reads the sorted
    keys' rank LCPs.
  * The per-k position-restoring sort becomes a store by position inside
    ``pcand.perk_level``: the seg-sorted keys carry a permutation of the
    positions.
  * The probe's tier 1 (JAX: a K10 gather of both spans' words, then
    jnp) is one kernel, ``probe_span``, that compares each live lane's
    spans straight from the bytes; its plain form keeps JAX's words, as
    uint32 values held in int64.
  * The probe's lanes carry the whole offset, so windows past 2047 (the
    generalized coders' profiles) extend their runs exactly, as JAX's
    one-block ``_extend`` does; JAX's batch form clips lane offsets at
    0x7FF.
"""

from __future__ import annotations

import torch

from .. import spec, trace
from . import _kernels, pcand, pext, pgather

_BIG = 0x3FFFFFFF
_NO_LANE = 0x7FFFFFFF  # above every probe lane key i << 15 | doff
_PROBE_CAP = 1024     # compacted probe lanes per row and wave
_T1_WORDS = 12        # tier-1 compare span: 12 words = 48 bytes


def clz32(z: torch.Tensor) -> torch.Tensor:
    """Leading zero bits of 32-bit unsigned values held in int64
    (32 for 0): ``lax.clz`` on uint32, by binary search on the top bits."""
    n = torch.zeros_like(z)
    for s in (16, 8, 4, 2, 1):
        small = z < (1 << (32 - s))
        n = n + small * s
        z = torch.where(small, z << s, z)
    return n + (z == 0)


_SIGN64 = torch.iinfo(torch.int64).min   # 1 << 63 as an int64 bit pattern


def _lead_bytes(z: torch.Tensor, width: int) -> torch.Tensor:
    """Leading zero bytes of width-byte values (int32 or int64 bit
    patterns): width for 0."""
    n = torch.zeros(z.shape, dtype=torch.int32, device=z.device)
    for t in range(1, width + 1):
        n += (z & -(1 << 8 * (width - t))) == 0    # the top t bytes
    return n


def _key_bytes(cap: int) -> int:
    """The bytes of a cap-byte gram's keys: cap rounded up to a word."""
    if not spec.MIN_MATCH <= cap <= 16:
        raise ValueError(f"cap {cap} outside [{spec.MIN_MATCH}, 16]")
    return 4 * -(-cap // 4)


def gram_keys_plain(x: torch.Tensor, cap: int):
    """Plain form of ``gram_keys``: shifts and ors of the bytes."""
    nbytes = _key_bytes(cap)
    b, npos = x.shape
    xe = torch.cat([x.to(torch.int64) & 0xFF,
                    x.new_zeros((b, nbytes), dtype=torch.int64)], 1)

    def word(lo: int, hi: int) -> torch.Tensor:
        """Bytes lo..hi-1 of every gram, big-endian."""
        v = xe[:, lo:lo + npos]
        for t in range(lo + 1, hi):
            v = (v << 8) | xe[:, t:t + npos]
        return v

    head = min(nbytes, 8)
    key0 = (word(0, head) << 8 * (8 - head)) ^ _SIGN64
    if nbytes <= 8:
        return key0, None
    if nbytes == 12:
        return key0, (word(8, 12) - (1 << 31)).to(torch.int32)
    return key0, word(8, 16) ^ _SIGN64


def gram_keys(x: torch.Tensor, cap: int):
    """The gram sort's keys of every position: x int32 (B, N) byte values
    -> (key0, key1) of grams of ``cap`` bytes rounded up to a word. key0:
    int64 (B, N), bytes i..i+7 big-endian XOR 1 << 63, so that its signed
    order is the bytes' order; key1: bytes i+8..i+11 XOR 1 << 31 as int32
    where the gram has 12 bytes, bytes i+8..i+15 XOR 1 << 63 as int64
    where it has 16, None where it has 4 or 8. Bytes at or past N and past
    the gram read 0. One launch of ``csrc/gram.cu`` on a CUDA tensor."""
    nbytes = _key_bytes(cap)
    if _kernels.on_cpu(x):
        return gram_keys_plain(x, cap)
    _kernels.check(x, "x", torch.int32)
    b, npos = x.shape
    key0 = torch.empty((b, npos), dtype=torch.int64, device=x.device)
    key1 = None if nbytes <= 8 else torch.empty(
        (b, npos), dtype=torch.int32 if nbytes == 12 else torch.int64,
        device=x.device)
    if b and npos:
        _kernels.GRAM_KEYS.launch(
            x.device, x.data_ptr(), key0.data_ptr(),
            None if key1 is None else key1.data_ptr(), b, npos, nbytes)
    return key0, key1


def rank_lcp_plain(s0: torch.Tensor, key1: torch.Tensor | None,
                   perm: torch.Tensor, cap: int):
    """Plain form of ``rank_lcp``."""
    lcp = _lead_bytes(s0[:, 1:] ^ s0[:, :-1], 8)
    if key1 is not None:
        k1 = key1.gather(1, perm)
        tail = _lead_bytes(k1[:, 1:] ^ k1[:, :-1], key1.element_size())
        lcp = torch.where(lcp == 8, 8 + tail, lcp)
    plcp = torch.cat([lcp.new_zeros((len(lcp), 1)), lcp.clamp(max=cap)], 1)
    return plcp, perm.to(torch.int32)


def rank_lcp(s0: torch.Tensor, key1: torch.Tensor | None,
             perm: torch.Tensor, cap: int):
    """(plcp, p) int32 (B, N) of rows sorted by (key0, key1, position):
    s0 the sorted key0, key1 the unsorted ``gram_keys`` key1 (or None),
    perm the sorted positions (int64). plcp[r] is the leading equal bytes
    of the grams at ranks r and r - 1, capped at ``cap`` (0 at rank 0);
    p is perm as int32. One launch of ``csrc/gram.cu`` on a CUDA tensor."""
    operands = (s0, perm) if key1 is None else (s0, key1, perm)
    if _kernels.on_cpu(*operands):
        return rank_lcp_plain(s0, key1, perm, cap)
    _kernels.check(s0, "s0", torch.int64)
    b, npos = s0.shape
    _kernels.check(perm, "perm", torch.int64, (b, npos))
    if key1 is not None:
        _kernels.check(key1, "key1", torch.int64 if key1.dtype == torch.int64
                       else torch.int32, (b, npos))
    plcp = torch.empty((b, npos), dtype=torch.int32, device=s0.device)
    p = torch.empty_like(plcp)
    if b and npos:
        _kernels.RANK_LCP.launch(
            s0.device, s0.data_ptr(),
            None if key1 is None else key1.data_ptr(), perm.data_ptr(),
            plcp.data_ptr(), p.data_ptr(), b, npos,
            0 if key1 is None else key1.element_size(), cap)
    return plcp, p


def gram_sort(x: torch.Tensor, cap: int):
    """(s0, key1, perm) of x int32 (B, N) byte values, for ``rank_lcp``:
    the ``gram_keys`` of grams of ``cap`` bytes, every row's positions
    sorted by (key0, key1, position) in stable sorts from the last key to
    the first; s0 the sorted key0, key1 unsorted (or None), perm the
    sorted positions (int64)."""
    key0, key1 = gram_keys(x.contiguous(), cap)
    if key1 is None:
        s0, perm = torch.sort(key0, dim=1, stable=True)
        return s0, None, perm
    order = torch.sort(key1, dim=1, stable=True).indices
    s0, step = torch.sort(key0.gather(1, order), dim=1, stable=True)
    return s0, key1, order.gather(1, step)


def candidates_batch(x: torch.Tensor, n: torch.Tensor, *,
                     window: int = spec.WINDOW_SIZE,
                     cap: int = spec.SEARCH_MATCH_MAX):
    """Per-position greedy (score, off) for a batch of blocks.

    x: int32[B, N] byte values (zeros past ``n``), N <= 32768; n: int32[B].
    Returns (score, off): int32[B, N] each (off = 0 where no match).
    """
    pext.check_npos(x.shape[1])
    plcp, p = rank_lcp(*gram_sort(x, cap), cap)
    return pcand.perk_candidates(plcp, p, n, kmin=spec.MIN_MATCH, kmax=cap,
                                 window=window)


def _aligned(w: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """(B, P, nt) gathered big-endian words and byte positions a (B, P) ->
    (B, P, nt - 1) words of x[a ..] aligned to the byte, as uint32 values
    held in int64."""
    w = w.to(torch.int64) & 0xFFFFFFFF
    sh = ((a & 3) * 8).to(torch.int64)[:, :, None]
    return ((w[:, :, :-1] << sh) | (w[:, :, 1:] >> (32 - sh))) & 0xFFFFFFFF


def probe_span_plain(x: torch.Tensor, n: torch.Tensor, srt: torch.Tensor,
                     cap: int):
    """Plain form of ``probe_span``: both sides' spans fetched from a
    big-endian word array of the rows (uint32 bits in int32) and compared
    a word at a time."""
    b, npos = x.shape
    p = srt.shape[1]
    nwords = (npos // 4 + _T1_WORDS + 2 + 127) & ~127
    xe = torch.cat([x, x.new_zeros((b, nwords * 4 - npos))], 1).reshape(
        b, nwords, 4).to(torch.int64)
    w64 = (xe[..., 0] << 24) | (xe[..., 1] << 16) | (xe[..., 2] << 8) \
        | xe[..., 3]
    words = (w64 - ((w64 >> 31) << 32)).to(torch.int32)  # uint32 bits
    nt = _T1_WORDS + 1
    tt = torch.arange(nt, dtype=torch.int32, device=x.device)
    lanes = srt < _NO_LANE
    cdoff = (srt & 0x7FFF).clamp(min=1)
    cbase = torch.where(lanes, srt >> 15, 0) + cap
    a = cbase.clamp(0, npos - 1)
    bpos = a - torch.minimum(cdoff, a)
    # one fetch of both sides' spans (2 * nt words per lane)
    idx = torch.cat([(a[:, :, None] >> 2) + tt,
                     (bpos[:, :, None] >> 2) + tt], 2).reshape(b, -1)
    got = pgather.gather_big_plain(words, idx).reshape(b, p, 2 * nt)
    lew = clz32(_aligned(got[:, :, :nt], a)
                ^ _aligned(got[:, :, nt:], bpos)) >> 3
    # equal bytes: 4 per leading equal word, then the leading equal bytes
    # of the first word that differs (JAX sums lew under a cummin mask; an
    # argmax finds the same word without a scan)
    part = lew != 4
    f = torch.where(part.any(2), part.to(torch.uint8).argmax(2), _T1_WORDS)
    last = lew.gather(2, f.clamp(max=_T1_WORDS - 1)[:, :, None])[:, :, 0]
    ext = (4 * f + torch.where(f < _T1_WORDS, last, 0)).to(torch.int32)
    full_span = ext >= 4 * _T1_WORDS
    ext = torch.minimum(ext, (n[:, None] - cbase).clamp(min=0))
    act = lanes & full_span & (cbase + ext < n[:, None])
    return torch.where(lanes, ext, 0), torch.where(act, cdoff, _BIG)


def probe_span(x: torch.Tensor, n: torch.Tensor, srt: torch.Tensor,
               cap: int):
    """Tier 1 of the probe over one wave's lanes: x int32 (B, N) byte
    values, n int32 (B), srt int32 (B, P) the wave's sorted lane keys
    i << 15 | doff (``_NO_LANE`` on an empty lane) -> (cln, dact) int32
    (B, P). For a live lane, with cbase = i + cap, a = min(cbase, N - 1)
    and d = max(doff, 1): cln is the leading equal bytes of x[a ..] and
    x[a - min(d, a) ..] over the 48-byte span (bytes past N read 0),
    clipped to max(n - cbase, 0); dact is d where the run fills the span
    and goes on inside the block (tier 2 closes it), ``_BIG`` elsewhere.
    An empty lane gives 0 and ``_BIG``. One launch of ``csrc/probe.cu``
    on a CUDA tensor."""
    if _kernels.on_cpu(x, n, srt):
        return probe_span_plain(x, n, srt, cap)
    _kernels.check(x, "x", torch.int32)
    b, npos = x.shape
    _kernels.check(n, "n", torch.int32, (b,))
    _kernels.check(srt, "srt", torch.int32)
    if srt.dim() != 2 or srt.shape[0] != b:
        raise ValueError(f"srt: expected ({b}, P), got {tuple(srt.shape)}")
    cln = torch.empty_like(srt)
    dact = torch.empty_like(srt)
    if srt.numel():
        _kernels.PROBE_SPAN.launch(
            x.device, x.data_ptr(), n.data_ptr(), srt.data_ptr(),
            cln.data_ptr(), dact.data_ptr(), b, srt.shape[1], npos, cap)
    return cln, dact


def _read(t: torch.Tensor) -> int:
    """``int(t)`` of a one-element tensor, under the host span ``wait``:
    the host blocks on the card's queue."""
    with trace.host("wait"):
        return int(t)


def _probe_batch(x: torch.Tensor, n: torch.Tensor, doff: torch.Tensor,
                 active: torch.Tensor, cap: int) -> torch.Tensor:
    """Exact run extension at the active positions of every block.

    For active (b, i): the length of the maximal run of
    x[b, a + t] == x[b, a + t - d] (t >= 0, a + t < n[b]) with a = i + cap
    and d = max(doff[b, i], 1). In waves of up to _PROBE_CAP lanes per
    row, compacted by one row sort: tier 1 compares 48-byte spans
    (``probe_span``); runs past the span close in tier 2, one batch-wide
    offset per round, with a diagonal-run column (K7 ``rcummin_rows``,
    K10 ``pgather.gather_big``); results return to their positions by
    probe rank (K6 ``rank_mask``, K10). Returns int32[B, N], 0 at inactive
    positions.
    """
    b, npos = x.shape
    dev = x.device
    x = x.contiguous()
    p = min(_PROBE_CAP, npos)
    i = torch.arange(npos, dtype=torch.int32, device=dev).expand(b, npos)
    nq = n[:, None]

    remaining = active
    length = torch.zeros((b, npos), dtype=torch.int32, device=dev)
    while _read(remaining.any()):
        # lane keys i << 15 | doff carry the whole offset (off <= i <
        # 2^15): JAX's batch form keeps 11 bits, so its probes at offsets
        # past 2047 compare at 2047; its one-block form, which its CPU
        # path runs, and this one take the offset itself
        packed = torch.where(remaining, (i << 15) | doff, _NO_LANE)
        srt = torch.sort(packed, dim=1).values[:, :p].contiguous()
        cln, dact = probe_span(x, n, srt, cap)

        # tier 2: close long runs, one batch-wide offset per round. Every
        # lane gathers the run column at its unclamped i + cap (an empty
        # lane's index lies past N, which gather_big clamps), but only
        # the round's lanes (dact == d0) take the value: each ran its
        # whole span inside n, so i + cap + 48 < n and i + cap is its a
        while True:
            d0 = _read(dact.min())
            if d0 == _BIG:
                break
            eq = (x == torch.roll(x, d0, 1)) & (i >= d0) & (i < nq)
            rm = pext.rcummin_rows(torch.where(eq, _BIG, i))
            col = (torch.minimum(rm, nq) - i).clamp(min=0)
            vals = pgather.gather_big(col, (srt >> 15) + cap)
            mine = dact == d0
            cln = torch.where(mine, vals, cln)
            dact = torch.where(mine, _BIG, dact)

        # deliver by probe rank: the wave took each row's first p active
        # positions in index order, so the r-th of them reads lane r
        rank = pext.rank_mask(remaining)
        vals = pgather.gather_big(cln, rank.clamp(0, p - 1))
        take = remaining & (rank < p)
        length = torch.where(take, vals, length)
        remaining = remaining & ~take
    return length


def _extend_batch(x: torch.Tensor, n: torch.Tensor, score: torch.Tensor,
                  off: torch.Tensor, cap: int) -> torch.Tensor:
    """Uncapped run length at the chosen offset for capped positions
    (``lzs_tpu.ops.sortmatch._extend_batch``; see ``_extend`` there for the
    run-end argument that pins most capped heads without a probe)."""
    packed = pext.ext_breaks(score, off, n, cap)
    need_probe = (packed & 1) != 0
    ext_res = packed >> 3
    ext_p = _probe_batch(x, n, off, need_probe, cap)
    ext_h = torch.where(need_probe, ext_p, ext_res)
    return pext.ext_fold(packed, ext_h, score, cap)


def best_matches_batch(x: torch.Tensor, n: torch.Tensor, *,
                       window: int = spec.WINDOW_SIZE,
                       cap: int = spec.SEARCH_MATCH_MAX):
    """int32[B, N] x, int32[B] n -> (score, off, full) int32[B, N] each."""
    x = x.to(torch.int32)
    with trace.stage("candidates"):
        score, off = candidates_batch(x, n, window=window, cap=cap)
    with trace.stage("extend"):
        full = _extend_batch(x, n, score, off, cap)
    return score, off, full


def candidates(x: torch.Tensor, n: torch.Tensor, *,
               window: int = spec.WINDOW_SIZE,
               cap: int = spec.SEARCH_MATCH_MAX):
    """One block of ``candidates_batch``: x int32[N] (zeros past ``n``),
    n an int32 scalar tensor -> (score, off) int32[N] each."""
    score, off = candidates_batch(x[None], n.reshape(1), window=window,
                                  cap=cap)
    return score[0], off[0]


def best_matches(x: torch.Tensor, n: torch.Tensor, *,
                 window: int = spec.WINDOW_SIZE,
                 cap: int = spec.SEARCH_MATCH_MAX):
    """One block of ``best_matches_batch``: x int32[N], n an int32 scalar
    tensor -> (score, off, full) int32[N] each. JAX's ``chunk`` sizes only
    the exhaustive backend's fold and has no counterpart here."""
    out = best_matches_batch(x[None], n.reshape(1), window=window, cap=cap)
    return tuple(o[0] for o in out)
