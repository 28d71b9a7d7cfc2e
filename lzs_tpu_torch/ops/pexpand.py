"""LZ77 copy expansion: filled parse records -> output bytes.

Port of ``lzs_tpu.ops.pexpand.expand_records`` (K17
``_expand_rec_kernel``). Every byte j finds its covering record, the
last slot of the nondecreasing filled record row whose output position
is <= j (a binary search with power-of-two steps). A literal record
gives its byte; a copy of offset d that starts at s gives the byte at
``s - d + (j - s) mod d`` (a copy longer than d is periodic, which also
linearizes RLE chains, lzs-decompression.c:346-365); sources before the
block start give 0 (the reference decoder's corrupt-input hygiene,
lzs-decompression.c:348-357). Sources are strictly before their own
record, so every chain of copies ends at a literal or a zero.

Status bits (per block, as LzsDecompressStatus_t, lzs.h:170-178):
  bit 0  a byte inside [0, n) had no covering record (parse underrun)
  bit 1  a copy source fell before the block start (offset too far)
As in the TPU kernel, whose empty record -1 decodes as a copy of offset
2047 from position -1, a byte with no covering record sets both bits.

On a CUDA tensor ``expand_records`` launches ``csrc/expand.cu`` (one
block per row walking it in chunks; a carried slot cursor streams the
record row through shared memory, where a max-scan of each chunk's
records by output position gives every byte its covering record; the
decoded row sits in shared memory where it fits and is read back from
the output in device memory above that, so a source before the current
chunk is a plain read); on a CPU tensor it runs ``expand_records_plain``,
which finds each byte's record by binary search and resolves the chains
by pointer doubling over the whole row.
"""

from __future__ import annotations

import torch

from . import _kernels

#: widest output row: records pack the output position as opos << 13
MAX_OUT_CAP = 1 << 18


def _covering(recfill: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """int64 index of the last slot with output position <= j (-1 if
    none), by the same power-of-two search as the kernel."""
    s = recfill.shape[1]
    opos = torch.where(recfill >= 0, recfill >> 13, -1)
    lo = torch.full(j.shape, -1, dtype=torch.int64, device=j.device)
    step = 1 << (s.bit_length() - 1) if s else 0
    while step:
        probe = lo + step
        pv = opos.gather(1, probe.clamp(max=s - 1))
        lo = torch.where((probe < s) & (pv <= j), probe, lo)
        step >>= 1
    return lo


def expand_records_plain(recfill: torch.Tensor, n: torch.Tensor,
                         out_cap: int):
    """Plain-torch ``expand_records`` (same results, any device)."""
    b, s = recfill.shape
    j = torch.arange(out_cap, dtype=torch.int32,
                     device=recfill.device).expand(b, out_cap)
    lo = _covering(recfill, j)
    rec = torch.where(lo >= 0, recfill.gather(1, lo.clamp(min=0)), -1)
    none = rec < 0
    is_copy = (~none) & (((rec >> 11) & 1) == 1)
    seg = rec >> 13
    d = (rec & 0x7FF).clamp(min=1)
    src = seg - d + torch.fmod(j - seg, d)
    nq = n[:, None]
    bad_cov = none & (j < nq)
    bad_src = (is_copy & (src < 0) | none) & (j < nq)

    # resolve copy chains: each unresolved byte points at its source
    res = (~is_copy) | (src < 0)
    val = torch.where((~none) & (~is_copy), rec & 0xFF, 0)
    ptr = torch.where(res, j, src).long()
    for _ in range(out_cap.bit_length() + 1):   # chains halve each round
        if bool(res.all()):
            break
        take = (~res) & res.gather(1, ptr)
        val = torch.where(take, val.gather(1, ptr), val)
        res = res | take
        ptr = torch.where(res, ptr, ptr.gather(1, ptr))
    out = torch.where(j < nq, val, 0).to(torch.uint8)
    status = bad_cov.any(1).to(torch.int32) | (
        bad_src.any(1).to(torch.int32) << 1)
    return out, status


def expand_records(recfill: torch.Tensor, n: torch.Tensor, out_cap: int):
    """Expand filled parse records straight into bytes.

    recfill: int32[B, S] nondecreasing filled records ((opos << 13) |
    (is_copy << 11) | payload; -1 before the first record); n: int32[B].
    Returns (out uint8[B, out_cap], status int32[B]).
    """
    if _kernels.on_cpu(recfill, n):
        return expand_records_plain(recfill, n, out_cap)
    b, s = recfill.shape
    _kernels.check(recfill, "recfill", torch.int32)
    _kernels.check(n, "n", torch.int32, (b,))
    if not 0 < out_cap <= MAX_OUT_CAP:
        raise ValueError(f"out_cap {out_cap} outside (0, {MAX_OUT_CAP}]")
    if s < 1:
        raise ValueError("recfill has no slots")
    out = torch.empty((b, out_cap), dtype=torch.uint8, device=n.device)
    status = torch.empty(b, dtype=torch.int32, device=n.device)
    if b:
        _kernels.EXPAND.launch(n.device, recfill.data_ptr(), n.data_ptr(),
                               b, s, out.data_ptr(), out_cap,
                               status.data_ptr())
    return out, status
