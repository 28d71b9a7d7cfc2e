"""Sort-based LZS match search, batched over blocks.

Port of ``lzs_tpu.ops.sortmatch`` in the form the JAX package runs off a
TPU: ``candidates`` vmapped over blocks and ``_extend`` vmapped over
blocks (no Pallas on that path). Per position i of each block:

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
  * The per-k position-restoring sort becomes a store by position: the
    seg-sorted keys carry a permutation of the positions.
  * The probe tier compares growing spans of every active lane of every
    block at once (``torch.nonzero`` compaction) instead of MXU gathers
    and per-offset diagonal columns; the run it measures is the same.
"""

from __future__ import annotations

import torch

from .. import spec, trace
from . import pext

_BIG = 0x3FFFFFFF
_PROBE_SPAN = 64      # first compare span of the probe tier, in bytes


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
    if npos > 1 << 15:
        raise ValueError("match search supports blocks up to 32768")
    if not spec.MIN_MATCH <= cap <= 16:
        raise ValueError(f"cap {cap} outside [{spec.MIN_MATCH}, 16]")
    dev = x.device
    nwords = -(-cap // 4)
    words = _gram_words(x.to(torch.int64), nwords)

    # lexicographic order of (word 0, ..., word nwords-1, position)
    perm = torch.arange(npos, device=dev).expand(b, npos)
    for col in reversed(words):
        order = torch.sort(col.gather(1, perm), dim=1, stable=True).indices
        perm = perm.gather(1, order)
    plcp = _rank_lcp_rows([col.gather(1, perm) for col in words], cap)
    p = perm.to(torch.int32)

    i = torch.arange(npos, dtype=torch.int32, device=dev).expand(b, npos)
    nq = n[:, None]
    score = torch.zeros((b, npos), dtype=torch.int32, device=dev)
    off = torch.zeros_like(score)
    first = torch.full((b, 1), -1, dtype=torch.int32, device=dev)
    for k in range(spec.MIN_MATCH, cap + 1):
        seg = pext.cummax_rows(torch.where(plcp < k, i, 0))
        skey = torch.sort((seg << 15) | p, dim=1).values
        prev = torch.cat([first, skey[:, :-1]], dim=1)
        mypos = skey & 0x7FFF
        prevpos = prev & 0x7FFF
        same = (skey >> 15) == (prev >> 15)
        cand = torch.where(same & (mypos - prevpos <= window), prevpos, -1)
        cand_k = torch.empty_like(cand).scatter_(1, mypos.long(), cand)
        hit = (cand_k >= 0) & (i + k <= nq)
        score = torch.where(hit, k, score)
        off = torch.where(hit, i - cand_k, off)
    return score, off


def _probe_batch(x: torch.Tensor, n: torch.Tensor, base: torch.Tensor,
                 doff: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """Exact run extension at the active positions of every block.

    For active (b, i): the length of the maximal run of
    x[b, a + t] == x[b, a + t - d] (t >= 0, a + t < n[b]) with a =
    base[b, i], d = max(doff[b, i], 1). Lanes of all blocks are compacted
    together; each round compares the next span of every lane still
    running, and the span doubles per round (long periodic runs close in
    log rounds). Returns int32[B, N], 0 at inactive positions.
    """
    b, npos = x.shape
    length = torch.zeros((b, npos), dtype=torch.int32, device=x.device)
    rows, cols = torch.nonzero(active, as_tuple=True)
    if rows.numel() == 0:
        return length
    flat = x.reshape(-1)
    a = base[rows, cols].long()
    d = doff[rows, cols].clamp(min=1).long()
    lim = n[rows].long()
    row0 = rows * npos
    run = torch.zeros_like(a)
    lanes = torch.arange(a.numel(), device=x.device)
    start, span = 0, _PROBE_SPAN
    while lanes.numel():
        pa = a[lanes, None] + (start + torch.arange(span, device=x.device))
        inside = pa < lim[lanes, None]
        r0 = row0[lanes, None]
        xa = flat[r0 + pa.clamp(max=npos - 1)]
        xb = flat[r0 + (pa - d[lanes, None]).clamp(0, npos - 1)]
        stop = ~((xa == xb) & inside)
        ended = stop.any(dim=1)
        run[lanes] += torch.where(ended, stop.to(torch.uint8).argmax(dim=1),
                                  span)
        lanes = lanes[~ended]
        start += span
        span *= 2
    length[rows, cols] = run.to(torch.int32)
    return length


def _extend(x: torch.Tensor, n: torch.Tensor, score: torch.Tensor,
            off: torch.Tensor, cap: int) -> torch.Tensor:
    """Uncapped run length at the chosen offset for capped positions
    (batched ``lzs_tpu.ops.sortmatch._extend``; see there for the run-end
    argument that pins most capped heads without a probe)."""
    b, npos = x.shape
    dev = x.device
    i = torch.arange(npos, dtype=torch.int32, device=dev).expand(b, npos)
    nq = n[:, None]
    capped = (score >= cap) & (i + cap < nq)
    prev_c = torch.cat([torch.zeros_like(capped[:, :1]), capped[:, :-1]], 1)
    prev_o = torch.cat([torch.zeros_like(off[:, :1]), off[:, :-1]], 1)
    head = capped & (~prev_c | (off != prev_o))

    brk = head | ~capped
    is_cap_score = (score >= cap).to(torch.int32)
    binfo = torch.where(brk, (i << 13) | (is_cap_score << 12)
                        | off.clamp(0, 0x7FF), _BIG)
    rcm = pext.rcummin_rows(binfo)                     # next break >= j
    nxt1 = torch.cat([rcm[:, 1:], torch.full_like(rcm[:, :1], _BIG)], 1)
    has_brk = nxt1 < _BIG
    e = torch.where(has_brk, nxt1 >> 13, npos)
    steal = has_brk & (((nxt1 >> 12) & 1) == 1) & ((nxt1 & 0x7FF) < off)
    # a break at e + cap == n says nothing about runlen(e, d): probe
    need_probe = head & ((e + cap >= nq) | steal)
    ext_res = e - i - 1
    ext_p = _probe_batch(x, n, i + cap, off, need_probe)
    ext_h = torch.where(need_probe, ext_p, ext_res)

    pk = pext.cummax_rows(torch.where(
        head, (i << 16) | (cap + ext_h).clamp(max=0xFFFF), -1))
    hfull = pk & 0xFFFF
    hpos = pk >> 16
    return torch.where(capped, hfull - (i - hpos), score)


def best_matches_batch(x: torch.Tensor, n: torch.Tensor, *,
                       window: int = spec.WINDOW_SIZE,
                       cap: int = spec.SEARCH_MATCH_MAX):
    """int32[B, N] x, int32[B] n -> (score, off, full) int32[B, N] each."""
    x = x.to(torch.int32)
    with trace.stage("candidates"):
        score, off = candidates_batch(x, n, window=window, cap=cap)
    with trace.stage("extend"):
        full = _extend(x, n, score, off, cap)
    return score, off, full
