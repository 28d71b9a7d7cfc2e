"""Per-k glue of the sort-based match search, over int32 (B, N) rows.

Port of ``lzs_tpu.ops.pcand``. For every match length k the search
builds packed keys from the rank LCPs (K1), sorts each row of keys, and
folds the sorted keys into a packed running best (K2+K3). One level is
one call, ``perk_level``: on a CUDA tensor it launches
``csrc/cand.cu``, which keeps the row in shared memory from the keys to
the fold; on a CPU tensor it runs the plain version, K1, a library row
sort and K2+K3 in turn.

JAX restores position order with a second row sort between K2 and K3.
The port does not: the low 15 bits of a row's sorted keys are a
permutation of its positions (``p`` holds every position, padding
included), so the fold stores each slot's result at its position.
"""

from __future__ import annotations

import torch

from . import _kernels
from .pext import check_npos, cummax_rows_plain


def perk_keys_plain(plcp: torch.Tensor, p: torch.Tensor,
                    k: int) -> torch.Tensor:
    """Level-k keys ``seg << 15 | p``: seg is the rank where the rank's
    k-segment starts (the last rank r' <= r with plcp[r'] < k)."""
    r = torch.arange(plcp.shape[1], dtype=torch.int32, device=plcp.device)
    seg = cummax_rows_plain(torch.where(plcp < k, r, 0))
    return (seg << 15) | p


def perk_back_acc_plain(skey: torch.Tensor, n: torch.Tensor,
                        pk: torch.Tensor, k: int,
                        window: int) -> torch.Tensor:
    """Fold the row-sorted level-k keys ``skey`` into ``pk``: slot j's
    predecessor in the same segment is the nearest earlier occurrence of
    the k-gram at mypos = skey[j] & 0x7FFF; where it lies within
    ``window`` and the gram fits the block, the result at mypos is
    max(pk, k << 16 | 32768 - off), else pk (also where no slot holds
    the position)."""
    prev = torch.cat([torch.full_like(skey[:, :1], -1), skey[:, :-1]], 1)
    mypos = skey & 0x7FFF
    prevpos = prev & 0x7FFF
    same = (skey >> 15) == (prev >> 15)
    cand = torch.where(same & (mypos - prevpos <= window), prevpos, -1)
    hit = (cand >= 0) & (mypos + k <= n[:, None])
    val = torch.where(hit, (k << 16) | (32768 - (mypos - cand)), -1)
    at_pos = torch.full_like(val, -1).scatter_(1, mypos.long(), val)
    return torch.maximum(pk, at_pos)


def perk_level_plain(plcp: torch.Tensor, p: torch.Tensor, n: torch.Tensor,
                     pk: torch.Tensor, k: int, window: int) -> torch.Tensor:
    skey = torch.sort(perk_keys_plain(plcp, p, k), dim=1).values
    return perk_back_acc_plain(skey, n, pk, k, window)


def perk_level(plcp: torch.Tensor, p: torch.Tensor, n: torch.Tensor,
               pk: torch.Tensor, k: int, window: int) -> torch.Tensor:
    """Fold match length k into the packed running best ``pk`` (out of
    place): K1, the row sort of its keys and K2+K3.

    plcp, p: int32[B, N] rank LCPs and sorted positions (the gram sort
    makes ``p`` permute 0..N-1 in every row; a position that ``p`` lacks
    keeps its ``pk``); n: int32[B] block lengths; pk: int32[B, N], -1
    where no lower level matched, else k' << 16 | 32768 - off.
    """
    check_npos(plcp.shape[-1])
    if _kernels.on_cpu(plcp, p, n, pk):
        return perk_level_plain(plcp, p, n, pk, k, window)
    return _kernels.launch_rows(_kernels.PERK_LEVEL,
                                {"plcp": plcp, "p": p, "n": n, "pk": pk},
                                k, window)


def perk_candidates(plcp: torch.Tensor, p: torch.Tensor, n: torch.Tensor, *,
                    kmin: int, kmax: int, window: int):
    """(score, off) int32[B, N] from the sorted-rank inputs.

    plcp, p: int32[B, N] rank LCPs and sorted positions per block; n:
    int32[B] block lengths. Any N up to 32768 (JAX's accelerator path
    takes multiples of 512).
    """
    pk = torch.full_like(plcp, -1)
    for k in range(kmin, kmax + 1):
        pk = perk_level(plcp, p, n, pk, k, window)
    hit = pk >= 0
    score = torch.where(hit, pk >> 16, 0)
    off = torch.where(hit, 32768 - (pk & 0xFFFF), 0)
    return score, off
