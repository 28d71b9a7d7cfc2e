"""Parallel raw-stream LZS decode: per-bit speculative parse + chain walk.

Port of ``lzs_tpu.ops.bitpar``. A raw (reference-compatible) LZS stream
has no sync metadata, so its token boundaries are data-dependent
(lzs-decompression.c:459-743 walks it one state at a time). Here:

  1. A token head is decoded speculatively at EVERY bit offset of the
     stream (flag, offset and length fields are fixed bit extractions,
     lzs-decompression.c:214-343), as plain elementwise torch.
  2. Extension-nibble chains (lzs-decompression.c:370-406) step by 4
     bits, so the 4 phase classes are rows of a reshape, and the added
     length of every chain is the segmented reverse recurrence
     y[t] = a[t] + g[t] * y[t+4] (``_seg_reverse_sum``).
  3. The successor of every bit (the next head if a head starts there)
     is then known, and the real heads are the orbit of bit 0: the token
     walk of the encoder (tokenize -> pwalk, kernels K11-K13 on the
     card) at one position per compressed bit.
  4. Each real head becomes one packed record; heads are >= 9 bits
     apart, so slot bit // 9 holds at most one and a reshape + max
     compacts them. The output offsets are a row cumsum (pext, K9), the
     record fill a row cummax (pext, K8) and the bytes come from the
     record expansion (pexpand, K17).

End markers (offset 0, lzs-decompression.c:255-261) end the chain, or in
multi-stream mode jump to the next byte boundary (lzs-decompression.c:
559-576). A head or nibble that overruns the input emits nothing and ends
the chain, the incremental decoder's starvation semantics.

A record packs its output position as opos << 13 into int32, which holds
positions below 2^18 (``MAX_OUT_CAP``). Up to that out_cap the records
fill and expand in one row, as in JAX. Past it (JAX's engine "bits" hands
such an out_cap to its scan engine, which corrupts the output, ROADMAP
F9) the output expands in windows of 2^18 bytes (``_expand_windows``):
each window's records are rebased to the window, behind 2048 bytes of
the output before it as literal records, since a copy reaches at most
2047 bytes back. The windows run one after another on the same kernels
(K8, K17).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import spec, trace
from . import pexpand, pext, tokenize
# the record format (opos << 13) bounds the output capacity
from .pexpand import MAX_OUT_CAP

#: fewest record slots per row: the TPU expansion's record window
_MIN_SLOTS = 768
_I32 = torch.int32
#: output bytes of one expansion row: a wider out_cap expands in windows
#: of this width
_ROW = MAX_OUT_CAP
#: the output bytes before a window that it carries as literal records: a
#: copy reaches at most 2047 bytes back
_HIST = 2048
#: the widest input of a decode past ``_ROW``: a row's sum of token
#: lengths (at most 15 output bytes per 4 input bits, and 8 per head of 9
#: bits or more) then stays below 2^31
MAX_WIDE_INPUT = 1 << 25
#: the widest out_cap of engine "bits"
MAX_WIDE_OUT_CAP = 1 << 30


def _seg_reverse_sum(a: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Solve y[t] = a[t] + g[t] * y[t+1] (y past the end = 0), last axis.

    a int32, g int32 in {0, 1}. y[t] sums a over [t, e(t)], where e(t) is
    the first k >= t with g[k] == 0 (the last index if none), so with P
    the inclusive prefix sum, y[t] = P[e(t)] - P[t] + a[t]. e is a row
    suffix min (pext, K7) and P a row cumsum (pext, K9); every sum wraps
    like int32, as the recurrence does. (JAX's blocked scan, F4, is a TPU
    workaround; this form is exact at any batch.)
    """
    shape = a.shape
    n = shape[-1]
    a2 = a.reshape(-1, n).to(_I32).contiguous()
    k = torch.arange(n, dtype=_I32, device=a.device)
    # a reshape of a transposed row can stay a view (B == 1): the
    # kernels take contiguous rows only
    e = pext.rcummin_rows(
        torch.where(g.reshape(-1, n) == 0, k, n - 1).contiguous())
    p = pext.cumsum_rows_wide(a2)
    return (p.gather(1, e.long()) - p + a2).reshape(shape)


def _shift_left(a: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """a[b, t + s[b, t]] with zero fill past the end; 0 <= s < 32."""
    b, n = a.shape
    idx = torch.arange(n, device=a.device) + s.long()
    return F.pad(a, (0, 32)).gather(1, idx.expand(b, n))


def _bit_windows(comp: torch.Tensor, cpad: int) -> torch.Tensor:
    """The big-endian 32-bit window starting at every bit: int32[B,
    8 * cpad] holding the bits of JAX's uint32 windows (a field is read
    as (w >> shift) & mask: the shift is arithmetic)."""
    b = comp.shape[0]
    by = comp.to(_I32)
    if by.shape[1] < cpad + 4:
        by = F.pad(by, (0, cpad + 4 - by.shape[1]))
    w8 = ((by[:, :cpad] << 24) | (by[:, 1:cpad + 1] << 16)
          | (by[:, 2:cpad + 2] << 8) | by[:, 3:cpad + 3])
    nxt = by[:, 4:cpad + 4]
    r = torch.arange(8, dtype=_I32, device=comp.device)
    w = (w8[:, :, None] << r) | (nxt[:, :, None] >> (8 - r))
    return w.reshape(b, cpad * 8)


def _heads(comp: torch.Tensor, inbits: torch.Tensor, nbits: int,
           out_cap: int, multi_stream: bool):
    """Per-bit speculative heads. Returns (delta int32[B, nbits] bits to
    the successor head, head_ok bool[B, nbits] the head fits the input,
    length int32[B, nbits] its output bytes (0 for an end marker), low
    int32[B, nbits] is_copy << 11 | payload, 0 for an end marker)."""
    b = comp.shape[0]
    cpad = nbits // 8
    t = torch.arange(nbits, dtype=_I32, device=comp.device)[None, :]
    w = _bit_windows(comp, cpad)

    # extension-nibble chains: only the added LENGTH is scanned; a
    # completed chain has len // 15 + 1 nibbles (non-terminal nibbles are
    # 15), and a truncated chain's overcount only moves its successor
    # deeper into starvation (a nibble needs 4 bits, a head >= 9)
    nib = (w >> 28) & 0xF
    valid = t + 4 <= inbits
    g = (valid & (nib == spec.MAX_EXTENDED_LENGTH)).to(_I32)
    a_len = torch.where(valid, nib, 0)
    del nib, valid
    q4 = nbits // 4
    ext_pack = _seg_reverse_sum(
        a_len.reshape(b, q4, 4).transpose(1, 2),
        g.reshape(b, q4, 4).transpose(1, 2)).transpose(1, 2).reshape(
            b, nbits)
    del a_len, g

    # head fields at every bit (lzs-decompression.c:214-343)
    is_lit = ((w >> 31) & 1) == 0
    lit = (w >> 23) & 0xFF
    short_off = ((w >> 30) & 1) == 1
    off7 = (w >> 23) & 0x7F
    off11 = (w >> 19) & 0x7FF
    l4 = torch.where(short_off, (w >> 19) & 0xF, (w >> 15) & 0xF)
    del w
    long_len = (l4 >> 2) == 3
    len_init = torch.where(long_len, (l4 & 3) + 5, (l4 >> 2) + 2)
    lw = (long_len.to(_I32) + 1) * 2                 # 4 if long, else 2
    is_marker = (~is_lit) & short_off & (off7 == 0)
    is_match = (~is_lit) & ~is_marker
    need = torch.where(is_lit | is_marker, 9,
                       torch.where(short_off, 9 + lw, 13 + lw))
    enters_ext = is_match & (l4 == 15)
    # the chain starts right after the head: bit t + need
    ext_here = torch.where(enters_ext, _shift_left(ext_pack, need), 0)
    del ext_pack

    head_ok = t + need <= inbits
    length = torch.where(is_lit, 1, torch.where(
        is_marker, 0, len_init + ext_here)).clamp(max=out_cap)
    consume = need + torch.where(enters_ext, 4 * (ext_here // 15 + 1), 0)
    succ_marker = (t + 9 + 7) & ~7 if multi_stream else nbits
    succ = torch.where(~head_ok, nbits,
                       torch.where(is_marker, succ_marker, t + consume))
    delta = (succ - t).clamp(min=1)
    payload = torch.where(is_lit, lit, torch.where(short_off, off7, off11))
    low = (is_match.to(_I32) << 11) | payload
    return delta.to(_I32), head_ok, length.to(_I32), low.to(_I32)


def _check_out_cap(out_cap: int, cpad: int) -> None:
    if not 0 < out_cap <= MAX_WIDE_OUT_CAP:
        raise ValueError(f"out_cap {out_cap} outside (0, {MAX_WIDE_OUT_CAP}]")
    if out_cap > _ROW and cpad > MAX_WIDE_INPUT:
        raise ValueError(
            f"input of {cpad} bytes past {MAX_WIDE_INPUT}: at out_cap "
            f"{out_cap} > {_ROW} the records' output positions are int32 "
            f"sums of the token lengths, which must stay below 2^31")


def decode_batch_bits(comp: torch.Tensor, inbytes: torch.Tensor, *,
                      out_cap: int, multi_stream: bool = False):
    """Parallel decode of a batch of raw LZS streams.

    comp: uint8/int32[B, C] compressed bytes (zero padding past
    ``inbytes`` is fine); inbytes: int32[B] valid input lengths; out_cap:
    output capacity in bytes (at most ``MAX_WIDE_OUT_CAP``; past
    ``MAX_OUT_CAP`` = 2^18 the output expands in windows and C is at most
    ``MAX_WIDE_INPUT``); multi_stream: continue across end markers
    (incremental semantics) instead of stopping at the first.

    Returns (out uint8[B, out_cap], out_len int32[B], end_markers
    int32[B]), the contract of ``decode.decode_batch``.
    """
    b, c0 = comp.shape
    # multiples of 1024 bytes, as in JAX (its walk's widest row block)
    cpad = max(-(-c0 // 1024) * 1024, 1024)
    _check_out_cap(out_cap, cpad)
    nbits = cpad * 8
    inbits = inbytes.to(_I32)[:, None] * 8

    with trace.stage("heads"):
        delta, head_ok, length, low = _heads(comp, inbits, nbits, out_cap,
                                             multi_stream)
    with trace.stage("walk"):
        heads = tokenize.token_starts(delta, inbits[:, 0])
        del delta
    s9 = -(-nbits // 9)
    spad = max(-(-s9 // 128) * 128, _MIN_SLOTS)
    if out_cap > _ROW:
        return _decode_wide(heads & head_ok, length, low, nbits, spad,
                            out_cap)
    with trace.stage("records"):
        # slot compaction first: heads are >= 9 bits apart, so bit // 9 is
        # injective over them and a max over each 9-bit group keeps the
        # one head's value (-1 where there is none); length <= 2^18 keeps
        # the value positive, and an end marker is the one all-zero value
        # (length 0, literal flag, payload = offset 0)
        packed = torch.where(heads & head_ok, (length << 12) | low, -1)
        del heads, head_ok, length, low
        packed = F.pad(packed, (0, spad * 9 - nbits), value=-1)
        slot = packed.reshape(b, spad, 9).amax(dim=2)
        del packed
        valid_s = slot >= 0
        len_s = torch.where(valid_s, slot >> 12, 0)
        opos = pext.cumsum_rows_wide(len_s, tile=spad) - len_s
        out_len = (opos[:, -1] + len_s[:, -1]).clamp(max=out_cap)
        kept = valid_s & (opos < out_cap)
        markers = (kept & (slot == 0)).sum(dim=1, dtype=_I32)
        # record = opos << 13 | is_copy << 11 | payload: the slot's low 12
        # bits; a marker leaves a zero-length record, which keeps record
        # gaps bounded across many empty streams
        rec = torch.where(kept, (opos.clamp(max=out_cap) << 13)
                          | (slot & 0xFFF), -1).contiguous()
    with trace.stage("raw_fill"):
        fill = pext.cummax_rows(rec)
    with trace.stage("raw_expand"):
        out, _ = pexpand.expand_records(fill, out_len.contiguous(), out_cap)
    return out, out_len, markers


def _decode_wide(real: torch.Tensor, length: torch.Tensor, low: torch.Tensor,
                 nbits: int, spad: int, out_cap: int):
    """The records stage and the expansion past ``_ROW``: the slots as
    the one-row path's, with each head's length and low bits kept apart
    (length << 12 leaves int32 past 2^19), and the output expanded in
    windows."""
    b = real.shape[0]
    with trace.stage("records"):
        # the one head of each 9-bit group, by its bit (-1 where none)
        at = torch.arange(nbits, dtype=_I32, device=real.device)
        at = F.pad(torch.where(real, at, -1), (0, spad * 9 - nbits),
                   value=-1)
        slot_at = at.reshape(b, spad, 9).amax(dim=2)
        del at
        valid_s = slot_at >= 0
        g = slot_at.clamp(min=0).long()
        len_s = torch.where(valid_s, length.gather(1, g), 0)
        low_s = low.gather(1, g)
        del g, slot_at
        opos = pext.cumsum_rows_wide(len_s, tile=spad) - len_s
        out_len = (opos[:, -1] + len_s[:, -1]).clamp(max=out_cap)
        kept = valid_s & (opos < out_cap)
        markers = (kept & (len_s == 0) & (low_s == 0)).sum(dim=1, dtype=_I32)
    out = _expand_windows(opos, len_s, low_s, kept, out_len, out_cap)
    return out, out_len, markers


def _expand_windows(opos: torch.Tensor, length: torch.Tensor,
                    low: torch.Tensor, kept: torch.Tensor,
                    out_len: torch.Tensor, out_cap: int) -> torch.Tensor:
    """uint8[B, out_cap]: the records' output, in windows of ``_ROW``
    bytes, each the one-row fill (K8) and expansion (K17) of:

      * ``_HIST`` literal records, the ``_HIST`` output bytes before the
        window (zeros before the first, which read as the sources before
        the block start do);
      * the copy that covers the window's first byte from before it, if
        one does, restarted there: a copy of offset d is d-periodic, so
        from any byte on it reads what it would have read;
      * the window's own records, opos rebased to the window.

    A window's last ``_ROW - _HIST`` bytes are new, and a window reads
    the bytes the one before it wrote, so they run in order. One read of
    the window bounds to the host. The windows' spans add up under the
    stages ``raw_fill`` and ``raw_expand``.
    """
    b, s = opos.shape
    dev = opos.device
    new = _ROW - _HIST
    nwin = -(-out_cap // new)
    with trace.stage("raw_fill"):
        w0 = torch.arange(nwin, dtype=_I32, device=dev) * new
        # window k's slots: lo[k] <= slot < lo[k + 1] (opos is
        # nondecreasing)
        lo = torch.searchsorted(opos, w0.expand(b, nwin).contiguous())
        # the last kept slot before each window, and whether it runs in
        idx = torch.arange(s, dtype=_I32, device=dev).expand(b, s)
        last = pext.cummax_rows(torch.where(kept, idx, -1).contiguous())
        prev = last.gather(1, (lo - 1).clamp(min=0))
        p = prev.clamp(min=0).long()
        runs_in = (lo > 0) & (prev >= 0) & (
            opos.gather(1, p) + length.gather(1, p) > w0)
        head = torch.where(runs_in, (_HIST << 13) | low.gather(1, p), -1)
        hist_at = torch.arange(_HIST, dtype=_I32, device=dev) << 13
        bounds = torch.cat([lo, torch.full((b, 1), s, device=dev,
                                           dtype=lo.dtype)], dim=1)
        bounds, lens = bounds.cpu().tolist(), out_len.cpu().tolist()
    out = torch.zeros((b, out_cap), dtype=torch.uint8, device=dev)
    for r in range(b):
        for k in range(-(-lens[r] // new)):
            start, a, e = k * new, bounds[r][k], bounds[r][k + 1]
            # zeros before the block start
            hist = F.pad(out[r, max(start - _HIST, 0):start],
                         (max(_HIST - start, 0), 0))
            rec = torch.cat([
                hist_at | hist.to(_I32), head[r, k:k + 1],
                torch.where(kept[r, a:e],
                            ((opos[r, a:e] - (start - _HIST)) << 13)
                            | low[r, a:e], -1)])
            with trace.stage("raw_fill"):
                fill = pext.cummax_rows(rec[None].contiguous())
            take = min(new, lens[r] - start)
            n = torch.full((1,), _HIST + take, dtype=_I32, device=dev)
            with trace.stage("raw_expand"):
                got, _ = pexpand.expand_records(fill, n, _ROW)
            out[r, start:start + take] = got[0, _HIST:_HIST + take]
    return out
