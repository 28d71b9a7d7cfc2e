"""Batched gather from wide per-row tables.

Port of ``lzs_tpu.ops.pgather`` (K10, ``_gather_kernel``):
``gather_big`` launches ``csrc/gather.cu`` on a CUDA tensor and runs the
plain version beside it on a CPU tensor. The TPU kernel walks the table
in 128-lane chunks and needs W and Q to be multiples of 128; the CUDA
kernel loads any entry, so any W >= 1 and any Q work.

Caller: the probe tier of the match extension (``sortmatch._probe_batch``)
fetches its compare spans, its diagonal run columns and its results by
probe rank with it; the reference's equivalents are the pointer walks in
lzs_match_len (lzs-compression.c:178-191).
"""

from __future__ import annotations

import torch

from . import _kernels


def gather_big_plain(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(tab, 1, idx.clamp(0, tab.shape[1] - 1).long())


def gather_big(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[b, q] = tab[b, clip(idx[b, q], 0, W - 1)] for int32[B, W] tab
    and int32[B, Q] idx."""
    if tab.dim() != 2 or idx.dim() != 2 or idx.shape[0] != tab.shape[0]:
        raise ValueError(f"tab (B, W) and idx (B, Q) expected, got "
                         f"{tuple(tab.shape)} and {tuple(idx.shape)}")
    b, w = tab.shape
    q = idx.shape[1]
    if w == 0 and b and q:
        raise ValueError("gather from an empty table")
    if _kernels.on_cpu(tab, idx):
        return gather_big_plain(tab, idx)
    _kernels.check(tab, "tab", torch.int32)
    _kernels.check(idx, "idx", torch.int32)
    out = torch.empty_like(idx)
    if b and q:
        _kernels.GATHER_BIG.launch(tab.device, tab.data_ptr(), idx.data_ptr(),
                                   out.data_ptr(), b, w, q)
    return out
