"""Row scans over int32 (B, N): prefix max and suffix min.

Port of the two ``lzs_tpu.ops.pext`` roll-scan kernels on the container
path: ``cummax_rows`` (K8, ``_cummax_kernel``) and ``rcummin_rows`` (K7,
``_rcummin_kernel``). On a CUDA tensor they launch ``csrc/rowscan.cu``;
on a CPU tensor they run the plain version beside them.

Callers: the emission-unit ownership scans (tokenize), the run-end
pinning of the match extension (sortmatch) and the record fill
(decode2).
"""

from __future__ import annotations

import torch

from . import _kernels


def cummax_rows_plain(v: torch.Tensor) -> torch.Tensor:
    return torch.cummax(v, dim=1).values


def rcummin_rows_plain(v: torch.Tensor) -> torch.Tensor:
    return torch.flip(torch.cummin(torch.flip(v, [1]), dim=1).values, [1])


def _launch(kernel: _kernels.Kernel, v: torch.Tensor) -> torch.Tensor:
    _kernels.check(v, "v", torch.int32)
    if v.dim() != 2:
        raise ValueError(f"v: expected (B, N), got {tuple(v.shape)}")
    out = torch.empty_like(v)
    b, n = v.shape
    if b and n:
        kernel.launch(v.device, v.data_ptr(), out.data_ptr(), b, n)
    return out


def cummax_rows(v: torch.Tensor) -> torch.Tensor:
    """Row-wise prefix cumulative max of int32[B, N]."""
    if _kernels.on_cpu(v):
        return cummax_rows_plain(v)
    return _launch(_kernels.CUMMAX, v)


def rcummin_rows(v: torch.Tensor) -> torch.Tensor:
    """Row-wise suffix cumulative min of int32[B, N]."""
    if _kernels.on_cpu(v):
        return rcummin_rows_plain(v)
    return _launch(_kernels.RCUMMIN, v)
