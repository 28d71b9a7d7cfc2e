"""Row scans over int32 (B, N): prefix max, suffix min and prefix sum.

Port of three ``lzs_tpu.ops.pext`` roll-scan kernels: ``cummax_rows``
(K8, ``_cummax_kernel``), ``rcummin_rows`` (K7, ``_rcummin_kernel``) and
``cumsum_rows_wide`` (K9, ``_cumsum_kernel``). On a CUDA tensor they
launch ``csrc/rowscan.cu``; on a CPU tensor they run the plain version
beside them.

Callers: the emission-unit ownership scans (tokenize), the run-end
pinning of the match extension (sortmatch), the record fill (decode2,
bitpar), and the raw decoder's output offsets and extension chains
(bitpar).
"""

from __future__ import annotations

import torch

from . import _kernels


def cummax_rows_plain(v: torch.Tensor) -> torch.Tensor:
    return torch.cummax(v, dim=1).values


def rcummin_rows_plain(v: torch.Tensor) -> torch.Tensor:
    return torch.flip(torch.cummin(torch.flip(v, [1]), dim=1).values, [1])


def cumsum_rows_plain(v: torch.Tensor) -> torch.Tensor:
    # int32 in, int32 out: torch.cumsum widens int32 to int64 otherwise
    return torch.cumsum(v, dim=1, dtype=torch.int32)


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


def cumsum_rows_wide(v: torch.Tensor, tile: int = 8192) -> torch.Tensor:
    """Row-wise inclusive prefix sum of int32[B, N], wrapping like int32.

    ``tile`` is the JAX signature's: the TPU kernel scans ``tile``-wide
    pieces because a row must fit VMEM. The kernel here carries the sum
    across its tiles in one launch, so any N works and ``tile`` is not
    read.
    """
    del tile
    if _kernels.on_cpu(v):
        return cumsum_rows_plain(v)
    return _launch(_kernels.CUMSUM, v)
