"""Raw LZS stream decode (no container metadata), batched over streams.

Port of ``lzs_tpu.ops.decode``'s entry points and both of its engines:

  "bits"  (default) the parallel per-bit parse and chain walk of
          ``ops.bitpar``;
  "scan"  the bit-serial parse, a mirror of the reference state machine
          (lzs-decompression.c:459-743) collapsed to two states
          (normal/extended) plus a done flag, with the single-call
          decoder's per-field input gates (lzs-decompression.c:214-343):
          one unit (a literal, a copy head, an extension nibble or an end
          marker) per step, at most ``max_units`` steps per stream. Its
          records (opos << 13 | is_copy << 11 | payload, -1 where a step
          has no output) go through the record fill (JAX's
          ``decode2._filled_records``) and the expansion
          (``pexpand.expand_records``, K17), as in JAX. The decode takes
          the parse in its filled form (``_parse_scan_filled``): on a
          CUDA tensor one launch of ``csrc/scan_parse.cu`` writes the
          filled rows, so the path is 2 launches; on a CPU tensor it runs
          ``_parse_scan_plain``, a torch loop over the steps, then the
          fill's layout and plain cummax.

Engine "bits" takes any input width and any ``out_cap`` up to
``bitpar.MAX_WIDE_OUT_CAP``: past ``MAX_OUT_CAP`` = 2^18 it expands its
output in windows of 2^18 bytes (``bitpar._expand_windows``), and an
input past ``bitpar._WIN`` bytes decodes in windows of the input
(``bitpar._window_loop``). Engine "scan" takes ``out_cap`` up to
2^18 and raises ValueError above it: its records pack the output position
as ``opos << 13`` into int32. (JAX sends any out_cap past 2^18 to its scan
engine, which packs positions from 2^18 on into the sign bit and past it
and so corrupts its output: ROADMAP F9.)

``max_units`` (the scan's step budget, ``default_max_units`` when None)
is taken by every entry point, as in JAX; engine "bits" does not read
it: the per-bit parse has no step budget.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from .. import spec, trace
from . import _kernels, bitpar, decode2, pexpand, pext
from .pexpand import MAX_OUT_CAP

_I32 = torch.int32
#: plain scan: steps between two tests of "every stream done" (a test
#: waits for the device)
_DONE_EVERY = 256


def default_max_units(out_cap: int) -> int:
    """Parse-step budget: every unit of a valid single stream produces at
    least one output byte, except one terminal zero-nibble per match token
    and the end marker."""
    return out_cap + out_cap // 2 + 8


def _check_args(out_cap: int, max_units: int, engine: str) -> None:
    if engine not in ("bits", "scan"):
        raise ValueError(f"unknown engine {engine!r}")
    # engine "bits" checks its own bounds (bitpar.decode_batch_bits)
    if engine == "scan" and not 0 < out_cap <= MAX_OUT_CAP:
        raise ValueError(
            f"out_cap {out_cap} outside (0, {MAX_OUT_CAP}] of engine "
            "\"scan\": its records pack the output position as opos << 13 "
            "into int32, which holds positions below 2^18 only (ROADMAP "
            "F9); engine \"bits\" takes a wider out_cap")
    if max_units < 0:
        raise ValueError(f"max_units {max_units} < 0")


def _parse_scan_plain(comp: torch.Tensor, inbytes: torch.Tensor, *,
                      out_cap: int, max_units: int,
                      multi_stream: bool = False):
    """Plain-torch ``_parse_scan`` (same results, any device): one torch
    step per unit over the batch, JAX's int32 arithmetic, stopping once
    every stream is done (tested every ``_DONE_EVERY`` steps)."""
    b, c = comp.shape
    dev = comp.device
    # the 40-bit big-endian window at every byte, bytes at or past C zero
    # (JAX appends 4 zero bytes and clamps its reads); the parse reads the
    # top 17 bits of the 32 at its bit position
    by = F.pad(comp.to(torch.int64), (0, 5))
    w5 = ((by[:, :c + 1] << 32) | (by[:, 1:c + 2] << 24)
          | (by[:, 2:c + 3] << 16) | (by[:, 3:c + 4] << 8) | by[:, 4:c + 5])
    del by
    inbits = inbytes.to(_I32) * 8
    zero = torch.zeros(b, dtype=_I32, device=dev)
    bitpos, mode, cur_off, count, markers = zero, zero, zero, zero, zero
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    recs = torch.full((b, max_units), -1, dtype=_I32, device=dev)
    for step in range(max_units):
        if step % _DONE_EVERY == 0 and bool(done.all()):
            break
        at = (bitpos >> 3).clamp(max=c).long()[:, None]
        w = (w5.gather(1, at)[:, 0] >> (8 - (bitpos & 7))).to(_I32)
        # NORMAL: one head; a short offset moved to the long one's layout
        is_lit = w >= 0
        short = ((w >> 30) & 1) == 1
        v = torch.where(short, w >> 4, w)
        n_off = (v >> 19) & torch.where(short, 0x7F, 0x7FF)
        l4 = (v >> 15) & 0xF
        long_len = l4 >= 12
        len_init = torch.where(long_len, (l4 & 3) + 5, (l4 >> 2) + 2)
        is_marker = ~is_lit & short & (n_off == 0)
        need = torch.where(is_lit | is_marker, 9,
                           torch.where(short, 11, 15) + 2 * long_len)
        n_len = torch.where(is_lit, 1, torch.where(is_marker, 0, len_init))
        n_consume = torch.where(is_marker, ((bitpos + 16) & ~7) - bitpos,
                                need)
        # EXTENDED: one length nibble
        nib = (w >> 28) & 0xF
        is_ext = mode == 1
        halt = done | (inbits - bitpos < torch.where(is_ext, 4, need))
        live = ~halt
        length = torch.where(live, torch.where(is_ext, nib, n_len),
                             0).minimum(out_cap - count)
        pay = torch.where(is_ext, cur_off, torch.where(is_lit, (w >> 23)
                                                       & 0xFF, n_off))
        is_copy = (is_ext | ~is_lit).to(_I32)
        recs[:, step] = torch.where(length > 0,
                                    (count << 13) | (is_copy << 11) | pay, -1)
        normal = live & ~is_ext
        bitpos = bitpos + torch.where(halt, 0, torch.where(is_ext, 4,
                                                           n_consume))
        mode = torch.where(halt, mode, torch.where(
            is_ext, nib == spec.MAX_EXTENDED_LENGTH,
            ~is_lit & ~is_marker & (l4 == 15)).to(_I32))
        cur_off = torch.where(normal & ~is_lit & ~is_marker, n_off, cur_off)
        markers = markers + (normal & is_marker).to(_I32)
        count = count + length
        done = halt | (count >= out_cap)
        if not multi_stream:
            done = done | (normal & is_marker)
    return recs, count.to(_I32), markers.to(_I32)


def _check_scan(comp: torch.Tensor, inbytes: torch.Tensor) -> int:
    """Validate the scan parse kernel's operands; returns B."""
    if comp.dim() != 2:
        raise ValueError(f"comp: expected (B, C), got {tuple(comp.shape)}")
    b = comp.shape[0]
    _kernels.check(comp, "comp", torch.uint8)
    _kernels.check(inbytes, "inbytes", _I32, (b,))
    return b


def _parse_scan_filled_plain(comp: torch.Tensor, inbytes: torch.Tensor, *,
                             out_cap: int, max_units: int,
                             multi_stream: bool = False):
    """Plain-torch ``_parse_scan_filled`` (any device): ``_parse_scan_plain``
    composed with ``decode2._filled_records`` (its layout, then the plain
    cummax)."""
    recs, out_len, markers = _parse_scan_plain(
        comp, inbytes, out_cap=out_cap, max_units=max_units,
        multi_stream=multi_stream)
    fill = pext.cummax_rows_plain(decode2._flat_records(recs[:, :, None]))
    return fill, out_len, markers


def _launch_scan(comp: torch.Tensor, inbytes: torch.Tensor, width: int, *,
                 out_cap: int, max_units: int, multi_stream: bool):
    """One launch of csrc/scan_parse.cu: width 0 writes the step-major
    records (rows of max_units), else the filled rows of ``width``."""
    b = _check_scan(comp, inbytes)
    out = torch.empty((b, width or max_units), dtype=_I32, device=comp.device)
    out_len = torch.empty(b, dtype=_I32, device=comp.device)
    markers = torch.empty(b, dtype=_I32, device=comp.device)
    if b:
        _kernels.SCAN_PARSE.launch(
            comp.device, comp.data_ptr(), inbytes.data_ptr(), b,
            comp.shape[1], max_units, out_cap, int(multi_stream),
            out.data_ptr(), width, out_len.data_ptr(), markers.data_ptr())
    return out, out_len, markers


def _parse_scan(comp: torch.Tensor, inbytes: torch.Tensor, *, out_cap: int,
                max_units: int, multi_stream: bool = False):
    """Bit-serial parse of a batch of raw LZS streams.

    comp: uint8[B, C] (bytes past C read as zero); inbytes: int32[B]
    valid input lengths. Returns (recs int32[B, max_units], out_len
    int32[B], end_markers int32[B]): recs[b, t] is step t's record,
    opos << 13 | is_copy << 11 | payload (a literal's byte, a copy's
    offset), or -1 where the step has no output (an end marker, a zero
    extension nibble, a step after the stream is done).
    """
    if _kernels.on_cpu(comp, inbytes):
        return _parse_scan_plain(comp, inbytes, out_cap=out_cap,
                                 max_units=max_units,
                                 multi_stream=multi_stream)
    return _launch_scan(comp, inbytes, 0, out_cap=out_cap,
                        max_units=max_units, multi_stream=multi_stream)


def _parse_scan_filled(comp: torch.Tensor, inbytes: torch.Tensor, *,
                       out_cap: int, max_units: int,
                       multi_stream: bool = False):
    """The parse in the form the expansion takes: (fill int32[B,
    decode2._flat_width(max_units)], out_len int32[B], end_markers
    int32[B]).

    fill is ``decode2._filled_records(recs[:, :, None])`` of
    ``_parse_scan``'s records: each step's record or the latest record
    before it, -1 before the first one, the last one repeated through the
    rest of the row. On a CUDA tensor one launch of csrc/scan_parse.cu
    writes it all.
    """
    if _kernels.on_cpu(comp, inbytes):
        return _parse_scan_filled_plain(comp, inbytes, out_cap=out_cap,
                                        max_units=max_units,
                                        multi_stream=multi_stream)
    return _launch_scan(comp, inbytes, decode2._flat_width(max_units),
                        out_cap=out_cap, max_units=max_units,
                        multi_stream=multi_stream)


def _decode_scan(comp: torch.Tensor, inbytes: torch.Tensor, *, out_cap: int,
                 max_units: int, multi_stream: bool):
    """Engine "scan": the parse in its filled form, then the expansion
    (K17); JAX's ``_decode_batch`` tail."""
    with trace.stage("scan_parse"):
        fill, out_len, markers = _parse_scan_filled(
            comp.contiguous(), inbytes.to(_I32).contiguous(),
            out_cap=out_cap, max_units=max_units, multi_stream=multi_stream)
    with trace.stage("scan_expand"):
        out, _ = pexpand.expand_records(fill, out_len, out_cap)
    return out, out_len, markers


def decode_batch(comp: torch.Tensor, inbytes: torch.Tensor, *,
                 out_cap: int, max_units: int | None = None,
                 multi_stream: bool = False, engine: str = "bits"):
    """Batched decode_block: (uint8[B, C], int32[B]) ->
    (uint8[B, out_cap], out_len int32[B], end_markers int32[B]).

    ``max_units`` is the scan engine's step budget; engine "bits" does not
    read it. bitpar buckets the input width to a multiple of 1 KiB, which
    JAX's decode_batch does here (for JAX it also reuses compiled
    programs); the scan reads bytes past C as zero, which is what JAX's
    bucket padding holds, so it takes the rows as they are.
    """
    if max_units is None:
        max_units = default_max_units(out_cap)
    _check_args(out_cap, max_units, engine)
    if engine == "scan":
        return _decode_scan(comp, inbytes, out_cap=out_cap,
                            max_units=max_units, multi_stream=multi_stream)
    return bitpar.decode_batch_bits(comp, inbytes, out_cap=out_cap,
                                    multi_stream=multi_stream)


def decode_block(comp: torch.Tensor, inbytes: torch.Tensor, *, out_cap: int,
                 max_units: int | None = None, multi_stream: bool = False,
                 engine: str = "bits"):
    """Decode one LZS stream.

    comp: uint8[C] compressed bytes (zero padding beyond ``inbytes`` is
    fine); inbytes: int32 scalar tensor, the valid input length;
    max_units: the scan engine's step budget (not read by engine "bits").
    Returns (out uint8[out_cap], out_len int32, end_markers int32).
    """
    out, out_len, markers = decode_batch(
        comp[None], inbytes.reshape(1), out_cap=out_cap, max_units=max_units,
        multi_stream=multi_stream, engine=engine)
    return out[0], out_len[0], markers[0]


def make_decoder(in_cap: int, out_cap: int, *, max_units: int | None = None,
                 multi_stream: bool = False, engine: str = "bits"):
    """Batch decoder: (uint8[B, in_cap], int32[B]) -> (uint8[B, out_cap],
    int32[B], int32[B]). ``in_cap`` is taken for the JAX signature and not
    read: any input width decodes; ``max_units`` and ``engine`` go to
    ``decode_batch``."""
    del in_cap
    return functools.partial(decode_batch, out_cap=out_cap,
                             max_units=max_units, multi_stream=multi_stream,
                             engine=engine)


def decode_bytes(data: bytes, out_cap: int, *, multi_stream: bool = False,
                 max_units: int | None = None, engine: str = "bits",
                 device: torch.device | str = "cuda") -> bytes:
    """Host helper: decode a single stream on ``device`` (the CUDA card
    unless the caller names another)."""
    buf = torch.from_numpy(np.frombuffer(data, np.uint8).copy()).to(device)
    n = torch.tensor(len(data), dtype=torch.int32, device=buf.device)
    out, out_len, _ = decode_block(buf, n, out_cap=out_cap,
                                   max_units=max_units,
                                   multi_stream=multi_stream, engine=engine)
    return out[:int(out_len)].cpu().numpy().tobytes()
