"""MSB-first bit packing with prefix-summed offsets.

Port of ``lzs_tpu.ops.bitpack.pack_bits_batch``. Every position carries
one right-aligned (value, width <= 25) unit; bit offsets are the
exclusive prefix sum of the widths and each unit lands in the 64-bit
big-endian window anchored at its start word. The work is one pass of
``ppack.pack_rows`` (a kernel on the card).
"""

from __future__ import annotations

import torch

from . import ppack


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
