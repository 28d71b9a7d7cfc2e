"""Sort-based LZS match search, batched over blocks.

Port of ``lzs_tpu.ops.sortmatch`` in the form the JAX package runs on its
accelerator: ``candidates_batch`` runs the per-k glue of ``pcand`` (K1, a
row sort and K2+K3, one kernel per level) and ``_extend_batch`` the
extension scans of ``pext`` (K4, the probe tier, K5); the probe tier
compacts its lanes into waves and runs on ``pgather.gather_big`` (K10),
``pext.rcummin_rows`` (K7) and ``pext.rank_mask`` (K6). Each kernel
stage launches a CUDA kernel on a CUDA tensor. Per position i of each
block:

  score[i] = max k in [2, cap] such that the k-gram at i occurs at some
             j in [i - window, i - 1]             (capped greedy score)
  off[i]   = i - j* where j* is the nearest such occurrence for k = score
  full[i]  = exact run length of the chosen offset (= score when < cap)

The policy is byte-identical to the reference C encoders
(lzs-compression.c:326-362); see ``lzs_tpu.ops.sortmatch`` for the
derivation of every step. What differs here:

  * The 12-byte gram sort is a chain of stable one-key sorts from the
    last key to the first (torch.sort takes one key). Gram words are
    uint32 values held in int64, since torch has no uint32 sort.
  * The per-k position-restoring sort becomes a store by position inside
    ``pcand.perk_level``: the seg-sorted keys carry a permutation of the
    positions.
  * The probe's gram words and byte-aligned spans are uint32 values held
    in int64 (the gathered words themselves are int32 bit patterns).
  * The probe's lanes carry the whole offset, so windows past 2047 (the
    generalized coders' profiles) extend their runs exactly, as JAX's
    one-block ``_extend`` does; JAX's batch form clips lane offsets at
    0x7FF.
"""

from __future__ import annotations

import torch

from .. import spec, trace
from . import pcand, pext, pgather

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


def _shift(x: torch.Tensor, s: int) -> torch.Tensor:
    """x[..., i + s] with zero padding at the end (last axis)."""
    if s == 0:
        return x
    return torch.cat([x[:, s:], torch.zeros_like(x[:, :s])], dim=1)


def _gram_words(x: torch.Tensor, nwords: int) -> list[torch.Tensor]:
    """Big-endian 4-byte gram words at each position: x int64 (B, N) byte
    values -> nwords int64 (B, N) uint32 values (zeros past the end)."""
    words = []
    for w in range(nwords):
        g = torch.zeros_like(x)
        for t in range(4):
            g = (g << 8) | _shift(x, 4 * w + t)
        words.append(g)
    return words


def _rank_lcp_rows(words: list[torch.Tensor], cap: int) -> torch.Tensor:
    """Byte LCP (capped at cap) of rank-adjacent sorted gram words; entry
    0 of every row is 0."""
    b, npos = words[0].shape
    lcp = torch.full((b, npos), cap, dtype=torch.int32, device=words[0].device)
    consumed = torch.zeros((b, npos), dtype=torch.bool, device=lcp.device)
    for wi, col in enumerate(words):
        prev = torch.cat([col[:, :1] ^ 0xFFFFFFFF, col[:, :-1]], dim=1)
        z = col ^ prev
        here = (4 * wi + (clz32(z) >> 3)).to(torch.int32)
        differs = z != 0
        lcp = torch.where(differs & ~consumed, here.clamp(max=cap), lcp)
        consumed = consumed | differs
    return lcp


def candidates_batch(x: torch.Tensor, n: torch.Tensor, *,
                     window: int = spec.WINDOW_SIZE,
                     cap: int = spec.SEARCH_MATCH_MAX):
    """Per-position greedy (score, off) for a batch of blocks.

    x: int32[B, N] byte values (zeros past ``n``), N <= 32768; n: int32[B].
    Returns (score, off): int32[B, N] each (off = 0 where no match).
    """
    b, npos = x.shape
    pext.check_npos(npos)
    if not spec.MIN_MATCH <= cap <= 16:
        raise ValueError(f"cap {cap} outside [{spec.MIN_MATCH}, 16]")
    nwords = -(-cap // 4)
    words = _gram_words(x.to(torch.int64), nwords)

    # lexicographic order of (word 0, ..., word nwords-1, position)
    perm = torch.arange(npos, device=x.device).expand(b, npos)
    for col in reversed(words):
        order = torch.sort(col.gather(1, perm), dim=1, stable=True).indices
        perm = perm.gather(1, order)
    plcp = _rank_lcp_rows([col.gather(1, perm) for col in words], cap)
    p = perm.to(torch.int32)

    return pcand.perk_candidates(plcp, p, n, kmin=spec.MIN_MATCH, kmax=cap,
                                 window=window)


def _aligned(w: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """(B, P, nt) gathered big-endian words and byte positions a (B, P) ->
    (B, P, nt - 1) words of x[a ..] aligned to the byte, as uint32 values
    held in int64."""
    w = w.to(torch.int64) & 0xFFFFFFFF
    sh = ((a & 3) * 8).to(torch.int64)[:, :, None]
    return ((w[:, :, :-1] << sh) | (w[:, :, 1:] >> (32 - sh))) & 0xFFFFFFFF


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
    row, compacted by one row sort: tier 1 compares 48-byte spans fetched
    with ``pgather.gather_big``; runs past the span close in tier 2, one
    batch-wide offset per round, with a diagonal-run column (K7
    ``rcummin_rows``); results return to their positions by probe rank
    (K6 ``rank_mask``). Returns int32[B, N], 0 at inactive positions.
    """
    b, npos = x.shape
    dev = x.device
    p = min(_PROBE_CAP, npos)
    nwords = (npos // 4 + _T1_WORDS + 2 + 127) & ~127
    xe = torch.cat([x, x.new_zeros((b, nwords * 4 - npos))], 1).reshape(
        b, nwords, 4).to(torch.int64)
    w64 = (xe[..., 0] << 24) | (xe[..., 1] << 16) | (xe[..., 2] << 8) \
        | xe[..., 3]
    words = (w64 - ((w64 >> 31) << 32)).to(torch.int32)  # uint32 bits
    i = torch.arange(npos, dtype=torch.int32, device=dev).expand(b, npos)
    nq = n[:, None]
    nt = _T1_WORDS + 1
    tt = torch.arange(nt, dtype=torch.int32, device=dev)

    remaining = active
    length = torch.zeros((b, npos), dtype=torch.int32, device=dev)
    while _read(remaining.any()):
        # lane keys i << 15 | doff carry the whole offset (off <= i <
        # 2^15): JAX's batch form keeps 11 bits, so its probes at offsets
        # past 2047 compare at 2047; its one-block form, which its CPU
        # path runs, and this one take the offset itself
        packed = torch.where(remaining, (i << 15) | doff, _NO_LANE)
        srt = torch.sort(packed, dim=1).values[:, :p]
        lanes = srt < _NO_LANE
        cdoff = (srt & 0x7FFF).clamp(min=1)
        cbase = torch.where(lanes, srt >> 15, 0) + cap
        a = cbase.clamp(0, npos - 1)
        bpos = a - torch.minimum(cdoff, a)

        # tier 1: one fetch of both sides' spans (2 * nt words per lane)
        idx = torch.cat([(a[:, :, None] >> 2) + tt,
                         (bpos[:, :, None] >> 2) + tt], 2).reshape(b, -1)
        got = pgather.gather_big(words, idx).reshape(b, p, 2 * nt)
        lew = clz32(_aligned(got[:, :, :nt], a)
                    ^ _aligned(got[:, :, nt:], bpos)) >> 3
        # equal bytes: 4 per leading equal word, then the leading equal
        # bytes of the first word that differs (JAX sums lew under a
        # cummin mask; an argmax finds the same word without a scan)
        part = lew != 4
        f = torch.where(part.any(2), part.to(torch.uint8).argmax(2),
                        _T1_WORDS)
        last = lew.gather(2, f.clamp(max=_T1_WORDS - 1)[:, :, None])[:, :, 0]
        ext = (4 * f + torch.where(f < _T1_WORDS, last, 0)).to(torch.int32)
        full_span = ext >= 4 * _T1_WORDS
        ext = torch.minimum(ext, (nq - cbase).clamp(min=0))
        cln = torch.where(lanes, ext, 0)
        act = lanes & full_span & (cbase + ext < nq)

        # tier 2: close long runs, one batch-wide offset per round
        while True:
            d0 = _read(torch.where(act, cdoff, _BIG).min())
            if d0 == _BIG:
                break
            eq = (x == torch.roll(x, d0, 1)) & (i >= d0) & (i < nq)
            rm = pext.rcummin_rows(torch.where(eq, _BIG, i))
            col = (torch.minimum(rm, nq) - i).clamp(min=0)
            vals = pgather.gather_big(col, a)
            mine = act & (cdoff == d0)
            cln = torch.where(mine, vals, cln)
            act = act & ~mine

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
