"""Bit packing of per-position units into big-endian stream bytes.

Port of ``lzs_tpu.ops.ppack`` (K14 ``_phase1_kernel`` and K15
``_phase2_kernel``) together with the two head-compaction sorts and the
end-marker splice of ``lzs_tpu.ops.bitpack.pack_bits_batch``. The TPU
form builds dense words with sorts because XLA scatters serialize there;
here every unit ORs its 64-bit anchored window straight into its word
and the next one. On a CUDA tensor ``pack_rows`` launches
``csrc/pack.cu`` (a row split over a cluster of up to 8 CTAs, each
segment's words in its shared memory); on a CPU tensor it runs
``pack_rows_plain``, which adds the windows with ``scatter_add_``: units
never share bits, so the sum is the OR.

MSB-first accumulation is the reference's 32-bit bit queue
(lzs-compression.c:303-313).
"""

from __future__ import annotations

import torch

from . import _kernels

_M32 = 0xFFFFFFFF
MAX_UNITS = 1 << 16   # the kernel's cluster: 8 segments of 8192 units


def _window(v: torch.Tensor, start: torch.Tensor, width):
    """(w0, hi, lo): the 64-bit big-endian window of a ``width``-bit
    field ``v`` (uint32 values in int64) that starts at bit ``start``,
    as the uint32 arithmetic of the TPU kernel computes it."""
    w0 = start >> 5
    end = (start & 31) + width
    hi = torch.where(end <= 32, (v << (32 - end).clamp(0, 31)) & _M32,
                     v >> (end - 32).clamp(0, 31))
    lo = torch.where(end <= 32, 0, (v << (64 - end).clamp(0, 31)) & _M32)
    return w0, hi, lo


def pack_rows_plain(value: torch.Tensor, width: torch.Tensor, cap_bytes: int,
                    end_marker: tuple[int, int] | None = None):
    """Plain-torch ``pack_rows`` (same results, any device)."""
    b, m = value.shape
    cap_words = cap_bytes // 4
    dev = value.device
    w = width.to(torch.int64)
    incl = torch.cumsum(w, dim=1)
    offs = incl - w
    total = incl[:, -1]
    w0, hi, lo = _window(value.to(torch.int64) & _M32, offs, w)
    live = w > 0
    hi = torch.where(live, hi, 0)
    lo = torch.where(live, lo, 0)

    # column cap_words collects whatever falls outside the row
    def slot(k):
        return torch.where((k >= 0) & (k < cap_words), k, cap_words)

    words = torch.zeros((b, cap_words + 1), dtype=torch.int64, device=dev)
    words.scatter_add_(1, slot(w0), hi)
    words.scatter_add_(1, slot(w0 + 1), lo)

    if end_marker is not None:
        emv, emb = end_marker
        emv_t = torch.full_like(total, emv & _M32)
        mw0, mhi, mlo = _window(emv_t, total, emb)
        for k, part in ((slot(mw0), mhi), (slot(mw0 + 1), mlo)):
            k = k[:, None]
            words.scatter_(1, k, words.gather(1, k) | part[:, None])
        total = total + emb

    wi = torch.arange(cap_words + 1, device=dev)
    nwords = (total + 31) >> 5
    words = torch.where(wi < nwords[:, None], words, 0)[:, :cap_words]
    return words_to_bytes(words), total.to(torch.int32), offs.to(torch.int32)


def words_to_bytes(words: torch.Tensor) -> torch.Tensor:
    """Big-endian 32-bit words (int32 bit patterns, or uint32 values in
    int64) [..., W] -> uint8[..., 4 W] (elementwise)."""
    shifts = torch.tensor([24, 16, 8, 0], device=words.device)
    b = ((words[..., None] >> shifts.to(words.dtype)) & 0xFF).to(torch.uint8)
    return b.reshape(*words.shape[:-1], words.shape[-1] * 4)


def pack_rows(value: torch.Tensor, width: torch.Tensor, cap_bytes: int,
              end_marker: tuple[int, int] | None = None):
    """Pack int32[B, M] right-aligned units (value < 2**width, width
    0..25) into big-endian bytes.

    Returns (comp uint8[B, cap_bytes], total_bits int32[B], offs int32[B,
    M] exclusive bit offsets). ``end_marker=(value, bits)`` appends one
    trailing unit after the last one (counted in total_bits). The kernel
    takes M <= MAX_UNITS and cap_bytes a multiple of 4.
    """
    b, m = value.shape
    if m == 0:
        raise ValueError("pack_rows: rows hold no units")
    if _kernels.on_cpu(value, width):
        return pack_rows_plain(value, width, cap_bytes, end_marker)
    if m > MAX_UNITS or cap_bytes % 4:
        raise ValueError(f"pack_rows: M={m} (at most {MAX_UNITS}), "
                         f"cap_bytes={cap_bytes} (a multiple of 4)")
    _kernels.check(value, "value", torch.int32)
    _kernels.check(width, "width", torch.int32, (b, m))
    comp = torch.empty((b, cap_bytes), dtype=torch.uint8, device=value.device)
    total = torch.empty(b, dtype=torch.int32, device=value.device)
    offs = torch.empty_like(value)
    emv, emb = end_marker if end_marker is not None else (0, 0)
    if b:
        _kernels.PACK.launch(
            value.device, value.data_ptr(), width.data_ptr(), b, m,
            comp.data_ptr(), cap_bytes, total.data_ptr(), offs.data_ptr(),
            emv, emb, int(end_marker is not None))
    return comp, total, offs
