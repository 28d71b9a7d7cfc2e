"""MSB-first bit packing with prefix-summed offsets.

Port of ``lzs_tpu.ops.bitpack``. Every position carries
one right-aligned (value, width <= 25) unit; bit offsets are the
exclusive prefix sum of the widths and each unit lands in the 64-bit
big-endian window anchored at its start word. The work is one pass of
``ppack.pack_rows`` (a kernel on the card).
"""

from __future__ import annotations

import torch

from . import ppack
from .ppack import words_to_bytes

__all__ = ["pack_bits", "pack_bits_batch", "read_window", "words_to_bytes"]


def pack_bits(value: torch.Tensor, width: torch.Tensor, cap_bytes: int,
              end_marker: tuple[int, int] | None = None):
    """One row of ``pack_bits_batch``: int32[M] value/width ->
    (uint8[cap_bytes], total_bits int32 scalar, offs int32[M])."""
    out, total_bits, offs = pack_bits_batch(value[None], width[None],
                                            cap_bytes, end_marker=end_marker)
    return out[0], total_bits[0], offs[0]


def pack_bits_batch(value: torch.Tensor, width: torch.Tensor,
                    cap_bytes: int, end_marker: tuple[int, int] | None = None):
    """int32[B, M] value/width -> (uint8[B, cap_bytes], total_bits
    int32[B], offs int32[B, M]).

    ``cap_bytes`` must be a multiple of 4 with >= 8 bytes of slack past
    the worst-case stream. ``end_marker=(value, bits)`` appends one
    trailing unit (the LZS end marker) after the last unit.
    """
    if cap_bytes % 4:
        raise ValueError(f"cap_bytes {cap_bytes} is not a multiple of 4")
    b, m = value.shape
    if m > 1 << 16 or cap_bytes // 4 > 1 << 14:
        raise ValueError(f"pack shape out of range: M={m}, cap={cap_bytes}")
    return ppack.pack_rows(value.to(torch.int32).contiguous(),
                           width.to(torch.int32).contiguous(), cap_bytes,
                           end_marker)


def read_window(data: torch.Tensor, bitpos: torch.Tensor) -> torch.Tensor:
    """The 32-bit big-endian window that starts at bit ``bitpos``, shifted
    so that bit becomes the MSB: uint32 values held in int64. ``data``
    holds byte values (any integer dtype) padded with >= 4 trailing
    zeros."""
    b = (bitpos >> 3).long()
    d = data.to(torch.int64)
    w = (d[b] << 24) | (d[b + 1] << 16) | (d[b + 2] << 8) | d[b + 3]
    return (w << (bitpos & 7).to(torch.int64)) & 0xFFFFFFFF
