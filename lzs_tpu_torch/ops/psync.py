"""Decode-sync records of the container encoder.

Port of ``lzs_tpu.ops.psync`` (K16 ``_sync_kernel``) together with the
three compaction sorts that follow it in
``lzs_tpu.ops.encode._sync_records_batch``. Per block row:

  * the owner-token cummax (start index, clipped offset) over the row;
  * the parse-step predicate: token heads and every ``nibbles``-th
    extension nibble (decode2's lane contract);
  * the next step's bit offset by a suffix min (``end_bits`` past the
    last step), and the span-crossing test.

A parse step is at most MAX_STEP_BITS < span bits, so the crossing step
of boundary ``span * c`` is unique and its record is stored straight
into slot ``c``; the TPU form sorted packed keys into the same slots
because XLA scatters serialize there. Slot 0 holds the stream start and
slots >= nsync the stream-end sentinel (end_bits, n). A crossing with
c >= nsync (end_bits a multiple of span) is dropped, as the sentinel
fill overwrote it in the sort form. The record keeps the TPU form's
fields bit for bit: the 0xFFF offset clip and 29 bits of record.

On a CUDA tensor ``sync_records`` launches ``csrc/sync.cu`` (a row over
a cluster of up to four CTAs, 16 positions per thread in registers; the
kernel reads ``starts`` as bytes, so the encoder's bool row goes in as it
is); on a CPU tensor it runs ``sync_records_plain``.
"""

from __future__ import annotations

import torch

from . import _kernels, pext

_BIG = 0x3FFFFFFF
_REC_MASK = 0x1FFFFFFF


def sync_records_plain(starts, width, off, offs, end_bits, n, *, span: int,
                       nibbles: int, short_len: int, ext_len: int,
                       nslots: int):
    """Plain-torch ``sync_records`` (same results, any device)."""
    b, npos = width.shape
    dev = width.device
    i = torch.arange(npos, dtype=torch.int32, device=dev)
    st = starts.to(torch.bool)
    is_nib = (~st) & (width == 4)
    okey = pext.cummax_rows_plain(
        torch.where(st, (i << 12) | off.clamp(max=0xFFF), -1))
    owner_i = okey >> 12
    owner_off = okey & 0xFFF
    t = i - owner_i - 1
    is_step = st | (is_nib & (torch.remainder(t, nibbles) == 0))
    opos = torch.where(st, i, owner_i + short_len + ext_len * t)
    rec = torch.where(st, i, opos | (1 << 17) | (owner_off << 18))

    so = torch.where(is_step, offs, _BIG)
    nxt = pext.rcummin_rows_plain(
        torch.cat([so, end_bits[:, None]], 1))[:, 1:]
    c = torch.div(nxt, span, rounding_mode="floor")
    cross = is_step & (torch.div(offs, span, rounding_mode="floor") < c)
    nsync = torch.div(end_bits + span - 1, span, rounding_mode="floor")

    live = torch.arange(nslots, device=dev)[None, :] < nsync[:, None]
    sync_bit = torch.where(live, 0, end_bits[:, None]).to(torch.int32)
    sync_out = torch.where(live, 0, n[:, None]).to(torch.int32)
    rows, cols = torch.nonzero(cross & (c < nsync[:, None]), as_tuple=True)
    slots = c[rows, cols].long()
    sync_bit[rows, slots] = offs[rows, cols]
    sync_out[rows, slots] = rec[rows, cols] & _REC_MASK
    return sync_bit, sync_out, nsync.to(torch.int32)


def sync_records(starts, width, off, offs, end_bits, n, *, span: int,
                 nibbles: int, short_len: int, ext_len: int, nslots: int):
    """(sync_bit, sync_out int32[B, nslots], nsync int32[B]).

    starts: bool, uint8 or int32[B, N] token starts (nonzero at a token
    head; the kernel reads bool and uint8 rows as they are, an int32 row
    costs one conversion); width, off, offs: int32[B, N] unit widths,
    match offsets, unit bit offsets, N <= 32768; end_bits: int32[B] bit
    offset of the end marker; n: int32[B] block lengths.
    """
    kw = dict(span=span, nibbles=nibbles, short_len=short_len,
              ext_len=ext_len, nslots=nslots)
    if _kernels.on_cpu(starts, width, off, offs, end_bits, n):
        return sync_records_plain(starts, width, off, offs, end_bits, n, **kw)
    b, npos = width.shape
    if starts.dtype == torch.int32:
        starts = starts != 0
    if starts.dtype not in (torch.bool, torch.uint8):
        raise TypeError(f"starts: expected bool, uint8 or int32, got "
                        f"{starts.dtype}")
    pext.check_npos(npos)
    _kernels.check(starts, "starts", starts.dtype, (b, npos))
    for name, t, shape in (("width", width, (b, npos)),
                           ("off", off, (b, npos)), ("offs", offs, (b, npos)),
                           ("end_bits", end_bits, (b,)), ("n", n, (b,))):
        _kernels.check(t, name, torch.int32, shape)
    dev = width.device
    sync_bit = torch.empty((b, nslots), dtype=torch.int32, device=dev)
    sync_out = torch.empty_like(sync_bit)
    nsync = torch.empty(b, dtype=torch.int32, device=dev)
    if b:
        _kernels.SYNC.launch(
            dev, starts.data_ptr(), width.data_ptr(), off.data_ptr(),
            offs.data_ptr(), end_bits.data_ptr(), n.data_ptr(), b, npos,
            span, nibbles, short_len, ext_len, nslots,
            sync_bit.data_ptr(), sync_out.data_ptr(), nsync.data_ptr())
    return sync_bit, sync_out, nsync
