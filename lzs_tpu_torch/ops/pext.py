"""Row scans over int32 (B, N): prefix max, suffix min, prefix sum and a
mask's exclusive count, and the match extension's two fused scans.

Port of six ``lzs_tpu.ops.pext`` roll-scan kernels: ``cummax_rows``
(K8, ``_cummax_kernel``), ``rcummin_rows`` (K7, ``_rcummin_kernel``),
``cumsum_rows_wide`` (K9, ``_cumsum_kernel``) and ``rank_mask`` (K6,
``_rank_kernel``) launch ``csrc/rowscan.cu`` on a CUDA tensor;
``ext_breaks`` (K4, ``_break_kernel``) and ``ext_fold`` (K5,
``_fold_kernel``) launch ``csrc/extend.cu``. On a CPU tensor each runs
the plain version beside it. K4-K9 are one chained scan (a CTA per
``cumsum_tile``-wide tile, the tiles' partial results chained through
status words in one launch), instantiated as max forward (K8, and K5
with its prologue in the load and its epilogue in the store), min
backward (K7, and K4, whose store takes the exclusive min) and sum
forward (K9, and K6, which reads bytes and stores the exclusive sum).

Callers: the emission-unit ownership scans (tokenize), the run-end
pinning of the match extension and its probe tier (sortmatch:
ext_breaks, ext_fold, rank_mask, rcummin_rows), the record fill
(decode2, bitpar), the raw decoder's output offsets (bitpar) and the
extension chains of its plain heads (``bitpar._heads_plain``; on the card
the heads kernel sums them itself).
"""

from __future__ import annotations

import torch

from . import _kernels

_BIG = 0x3FFFFFFF
MAX_NPOS = 1 << 15        # the match search packs positions into 15 bits
SUM_TILES = (4096, 8192)  # chained scans: 256 threads x 16 or x 32


def check_npos(npos: int) -> None:
    """Reject rows wider than the match search's packed positions."""
    if npos > MAX_NPOS:
        raise ValueError(f"rows of {npos} positions: at most {MAX_NPOS}")


def cummax_rows_plain(v: torch.Tensor) -> torch.Tensor:
    return torch.cummax(v, dim=1).values


def rcummin_rows_plain(v: torch.Tensor) -> torch.Tensor:
    return torch.flip(torch.cummin(torch.flip(v, [1]), dim=1).values, [1])


def cumsum_rows_plain(v: torch.Tensor) -> torch.Tensor:
    # int32 in, int32 out: torch.cumsum widens int32 to int64 otherwise
    return torch.cumsum(v, dim=1, dtype=torch.int32)


def rank_mask_plain(mask: torch.Tensor) -> torch.Tensor:
    m = mask.to(torch.int32)
    return torch.cumsum(m, dim=1, dtype=torch.int32) - m


def _chain(kernel: _kernels.Kernel, operands: dict[str, torch.Tensor],
           *scalars: int, dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """Launch a chained row scan (K4-K9) over [B, N] operands (the first
    of ``dtype``, the others int32): ``cumsum_tile`` elements per CTA,
    status words from ``stream_words`` (after the kernel's own
    ``scalars``)."""
    v = next(iter(operands.values()))
    b, npos = v.shape if v.dim() == 2 else (0, 0)
    dev = v.device
    tile = cumsum_tile(b, npos, _kernels.sm_count(dev.index))
    # the kernels' epoch word, then one status word per tile
    words = _kernels.stream_words(dev, 1 + b * -(-npos // tile))
    return _kernels.launch_rows(kernel, operands, *scalars, tile,
                                words.data_ptr(), words.numel() - 1,
                                dtype=dtype)


def cummax_rows(v: torch.Tensor) -> torch.Tensor:
    """Row-wise prefix cumulative max of int32[B, N]."""
    if _kernels.on_cpu(v):
        return cummax_rows_plain(v)
    return _chain(_kernels.CUMMAX, {"v": v})


def rcummin_rows(v: torch.Tensor) -> torch.Tensor:
    """Row-wise suffix cumulative min of int32[B, N]."""
    if _kernels.on_cpu(v):
        return rcummin_rows_plain(v)
    return _chain(_kernels.RCUMMIN, {"v": v})


def cumsum_tile(b: int, npos: int, sms: int) -> int:
    """Elements per CTA of the chained row scans (K4-K9) for B rows of N
    on a card of ``sms`` SMs: SUM_TILES[1] where the rows make at least 4
    such tiles per SM, else SUM_TILES[0], so that few rows still spread
    over the card."""
    big = SUM_TILES[1]
    return big if b * -(-npos // big) >= 4 * sms else SUM_TILES[0]


def cumsum_rows_wide(v: torch.Tensor, tile: int = 8192) -> torch.Tensor:
    """Row-wise inclusive prefix sum of int32[B, N], wrapping like int32.

    ``tile`` is the JAX signature's: the TPU kernel scans ``tile``-wide
    pieces because a row must fit VMEM. The kernel here chains the sums of
    its tiles (``cumsum_tile`` wide, one CTA each) in one launch, so any N
    works and ``tile`` is not read.
    """
    del tile
    if _kernels.on_cpu(v):
        return cumsum_rows_plain(v)
    return _chain(_kernels.CUMSUM, {"v": v})


def rank_mask(mask: torch.Tensor) -> torch.Tensor:
    """int32[B, N] exclusive running count of the set entries of a
    bool[B, N] mask, per row (the probe tier's compaction rank)."""
    if _kernels.on_cpu(mask):
        return rank_mask_plain(mask)
    return _chain(_kernels.RANK_MASK, {"mask": mask}, dtype=torch.bool)


def ext_breaks_plain(score: torch.Tensor, off: torch.Tensor, n: torch.Tensor,
                     cap: int) -> torch.Tensor:
    npos = score.shape[1]
    i = torch.arange(npos, dtype=torch.int32, device=score.device)
    nq = n[:, None]
    capped = (score >= cap) & (i + cap < nq)
    prev_c = torch.cat([torch.zeros_like(capped[:, :1]), capped[:, :-1]], 1)
    prev_o = torch.cat([torch.zeros_like(off[:, :1]), off[:, :-1]], 1)
    head = capped & (~prev_c | (off != prev_o))
    brk = head | ~capped
    is_cap = (score >= cap).to(torch.int32)
    binfo = torch.where(brk, (i << 13) | (is_cap << 12) | off.clamp(0, 0x7FF),
                        _BIG)
    rcm = rcummin_rows_plain(binfo)                  # next break >= j
    nxt1 = torch.cat([rcm[:, 1:], torch.full_like(rcm[:, :1], _BIG)], 1)
    has_brk = nxt1 < _BIG
    e = torch.where(has_brk, nxt1 >> 13, npos)
    steal = has_brk & (((nxt1 >> 12) & 1) == 1) & ((nxt1 & 0x7FF) < off)
    # a break at e + cap == n says nothing about runlen(e, d): probe
    need_probe = head & ((e + cap >= nq) | steal)
    ext_res = e - i - 1
    return ((ext_res << 3) | (head.to(torch.int32) << 2)
            | (capped.to(torch.int32) << 1) | need_probe.to(torch.int32))


def ext_breaks(score: torch.Tensor, off: torch.Tensor, n: torch.Tensor,
               cap: int) -> torch.Tensor:
    """Packed ``ext_res << 3 | head << 2 | capped << 1 | need_probe`` of
    int32[B, N] greedy (score, off) and int32[B] block lengths, N <= 32768.

    A head starts a maximal run of capped positions (score >= cap, i + cap
    < n) with one offset; ext_res = e - i - 1 for the next break e after
    i (a head or an uncapped position), which pins a head's extension
    unless the run meets the data end or a nearer capped offset steals it
    (need_probe; ``lzs_tpu.ops.sortmatch._extend`` has the argument).
    """
    check_npos(score.shape[-1])
    if _kernels.on_cpu(score, off, n):
        return ext_breaks_plain(score, off, n, cap)
    return _chain(_kernels.EXT_BREAKS, {"score": score, "off": off, "n": n},
                  cap)


def fold_prologue(packed: torch.Tensor, ext_h: torch.Tensor,
                  cap: int) -> torch.Tensor:
    """The values ext_fold scans: i << 16 | min(cap + ext_h, 0xFFFF) at a
    head, -1 elsewhere."""
    i = torch.arange(packed.shape[1], dtype=torch.int32,
                     device=packed.device)
    head = ((packed >> 2) & 1) != 0
    return torch.where(head, (i << 16) | (cap + ext_h).clamp(max=0xFFFF), -1)


def ext_fold_plain(packed: torch.Tensor, ext_h: torch.Tensor,
                   score: torch.Tensor, cap: int) -> torch.Tensor:
    i = torch.arange(packed.shape[1], dtype=torch.int32,
                     device=packed.device)
    capped = ((packed >> 1) & 1) != 0
    pk = cummax_rows_plain(fold_prologue(packed, ext_h, cap))
    return torch.where(capped, (pk & 0xFFFF) - (i - (pk >> 16)), score)


def ext_fold(packed: torch.Tensor, ext_h: torch.Tensor, score: torch.Tensor,
             cap: int) -> torch.Tensor:
    """Full run lengths int32[B, N]: at a capped position the extension
    ``cap + ext_h`` of its run's head less the distance to the head
    (a run loses one byte per position), ``score`` elsewhere. ``packed``
    is ext_breaks' output; ext_h int32[B, N] is read at heads."""
    check_npos(packed.shape[-1])
    if _kernels.on_cpu(packed, ext_h, score):
        return ext_fold_plain(packed, ext_h, score, cap)
    return _chain(_kernels.EXT_FOLD,
                  {"packed": packed, "ext_h": ext_h, "score": score}, cap)
