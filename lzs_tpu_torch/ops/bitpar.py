"""Parallel raw-stream LZS decode: per-bit speculative parse + chain walk.

Port of ``lzs_tpu.ops.bitpar``. A raw (reference-compatible) LZS stream
has no sync metadata, so its token boundaries are data-dependent
(lzs-decompression.c:459-743 walks it one state at a time). Here:

  1. A token head is decoded speculatively at EVERY bit offset of the
     stream (flag, offset and length fields are fixed bit extractions,
     lzs-decompression.c:214-343).
  2. Extension-nibble chains (lzs-decompression.c:370-406) step by 4
     bits, so the 4 phase classes are chains of their own, and the added
     length of every chain is the segmented reverse recurrence
     y[t] = a[t] + g[t] * y[t+4]. Steps 1 and 2 are ``_heads``: on the
     card one launch of ``csrc/heads.cu``, on the CPU plain elementwise
     torch (``_heads_plain``, the chains a reshape into the 4 classes and
     ``_seg_reverse_sum``).
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

An input wider than ``_WIN`` bytes (padded), or an out_cap past 2^18,
decodes in windows of the input (``_window_loop``), so any input width
decodes: each window runs steps 1-4 on a span of each row from the row's
entry head, at most ``_WIN + _MARGIN`` bytes, and keeps the heads that
the span decides (``_final``); the first head it cannot decide is the
next window's entry. A head whose run of extension nibbles passes the
span is cut there (``_cut``): the window emits the copy up to the cut,
and the next one enters the run at the cut, so a token of any length
decodes, one record a window, and each span's sums stay in int32
(``MAX_WIDE_INPUT``). ``decode_to_host`` runs the same loop with no
output capacity and appends each window's output on the host (the
CLI's raw decode).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import spec, trace
from . import _kernels, pexpand, pext, tokenize
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
#: the widest span of input bytes that one pass of the per-bit parse
#: may read: its token lengths (at most 15 output bytes per 4 input bits,
#: and 8 per head of 9 bits or more: 30 bytes an input byte) then sum
#: below 2^31. A window's span, ``_WIN + _MARGIN`` bytes at most, is
#: held to it
MAX_WIDE_INPUT = 1 << 26
#: the widest out_cap of engine "bits"
MAX_WIDE_OUT_CAP = 1 << 30
#: new input bytes of one input window, shared by the rows that a window
#: decodes; a padded input at most this wide decodes in one pass at an
#: out_cap up to ``_ROW``. A
#: window's span peaked at 5.06 GiB of device memory at 2^23, 10.13 at
#: 2^24 and 18.78 at 2^25, at the same speed (scripts/raw_windows.py on
#: an H100), while the heads stage was plain torch; with the heads kernel
#: it peaks at 3.20 GiB over its input at 2^23 (chip_smoke.py)
_WIN = 1 << 23
#: input bytes a window reads past its new bytes: a head that starts in
#: the new bytes is decided there if its successor lies inside the span
#: (8 or more, so that every head but a long run's is, see ``_cut``)
_MARGIN = 1 << 12
#: the fewest 15-nibbles that a cut run keeps in its span past the cut
_CUT_KEEP = 3
#: a window's output length when nothing caps it (int32's largest)
_NO_CAP = (1 << 31) - 1
#: bits of a row that one CTA of the heads kernel takes (csrc/heads.cu)
_TILE = 1 << 14


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
           out_cap: int, multi_stream: bool, carry=None):
    """Per-bit speculative heads. Returns (delta int32[B, nbits] bits to
    the successor head, head_ok bool[B, nbits] the head fits the input,
    length int32[B, nbits] its output bytes (0 for an end marker), low
    int32[B, nbits] is_copy << 11 | payload, 0 for an end marker).

    comp: uint8/int32[B, C] bytes (past C, and past nbits // 8 + 4, read
    as zero); inbits: int32[B, 1] input bits; nbits: a multiple of 8,
    at most 8 * ``MAX_WIDE_INPUT`` (the kernel refuses others).
    carry: None, or (bit int32[B], offset int32[B]): where offset >= 0,
    the row's head at ``bit`` continues a copy of that offset whose run
    of extension nibbles an earlier input window cut there
    (``_window_loop``). It has no fields of its own (need 0, len_init 0):
    its chain starts at the bit itself, so its length is the chain's sum
    there and its successor lies past the chain.

    CPU tensors run ``_heads_plain``; CUDA tensors launch the heads
    kernel once (int32 bytes are narrowed to uint8 first)."""
    carry = () if carry is None else carry
    if _kernels.on_cpu(comp, inbits, *carry):
        return _heads_plain(comp, inbits, nbits, out_cap, multi_stream,
                            carry or None)
    b = comp.shape[0]
    dev = comp.device
    comp = comp.to(torch.uint8).contiguous()
    inbits = inbits.reshape(b).to(_I32).contiguous()
    carry = [x.to(_I32).contiguous() for x in carry]
    planes = (torch.empty((b, nbits), dtype=_I32, device=dev),
              torch.empty((b, nbits), dtype=torch.bool, device=dev),
              torch.empty((b, nbits), dtype=_I32, device=dev),
              torch.empty((b, nbits), dtype=_I32, device=dev))
    if b:
        # a row's tiles chain their nibble runs through 4 status words each
        words = _kernels.stream_words(dev, 1 + 4 * b * -(-nbits // _TILE))
        _kernels.RAW_HEADS.launch(
            dev, comp.data_ptr(), comp.shape[1], inbits.data_ptr(),
            *([x.data_ptr() for x in carry] or (None, None)),
            *(x.data_ptr() for x in planes), b, nbits, out_cap,
            int(multi_stream), words.data_ptr(), words.numel() - 1)
    return planes


def _heads_plain(comp: torch.Tensor, inbits: torch.Tensor, nbits: int,
                 out_cap: int, multi_stream: bool, carry=None):
    """``_heads`` as plain torch."""
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
    if carry is not None:
        at = carry[0][:, None].long()
        ext_at = ext_pack.gather(1, at)

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
    delta, length, low = delta.to(_I32), length.to(_I32), low.to(_I32)
    if carry is not None:
        on = carry[1][:, None] >= 0
        for field, value in (
                (delta, 4 * (ext_at // 15 + 1)),
                (head_ok, at <= inbits),
                (length, ext_at.clamp(max=out_cap)),
                (low, (1 << 11) | carry[1][:, None])):
            field.scatter_(1, at, torch.where(on, value.to(field.dtype),
                                              field.gather(1, at)))
    return delta, head_ok, length, low


def _check_out_cap(out_cap: int) -> None:
    if not 0 < out_cap <= MAX_WIDE_OUT_CAP:
        raise ValueError(f"out_cap {out_cap} outside (0, {MAX_WIDE_OUT_CAP}]")


def _padded(c0: int) -> int:
    """The input bytes of a row C wide: multiples of 1024, as in JAX (its
    walk's widest row block)."""
    return max(-(-c0 // 1024) * 1024, 1024)


def _slot_width(nbits: int) -> int:
    """Record slots of a row of ``nbits`` bit nodes: one per 9 bits."""
    s9 = -(-nbits // 9)
    return max(-(-s9 // 128) * 128, _MIN_SLOTS)


def decode_batch_bits(comp: torch.Tensor, inbytes: torch.Tensor, *,
                      out_cap: int, multi_stream: bool = False):
    """Parallel decode of a batch of raw LZS streams.

    comp: uint8/int32[B, C] compressed bytes (zero padding past
    ``inbytes`` is fine); inbytes: int32[B] valid input lengths; out_cap:
    output capacity in bytes (at most ``MAX_WIDE_OUT_CAP``; past
    ``MAX_OUT_CAP`` = 2^18, or with C past ``_WIN``, the decode runs in
    windows of the input and its output expands in windows of 2^18
    bytes); multi_stream: continue across end markers (incremental
    semantics) instead of stopping at the first.

    Returns (out uint8[B, out_cap], out_len int32[B], end_markers
    int32[B]), the contract of ``decode.decode_batch``.
    """
    b, c0 = comp.shape
    cpad = _padded(c0)
    _check_out_cap(out_cap)
    if cpad > _WIN or out_cap > _ROW:
        return _decode_windows(comp, inbytes, out_cap, multi_stream)
    nbits = cpad * 8
    inbits = inbytes.to(_I32)[:, None] * 8

    with trace.stage("heads"):
        delta, head_ok, length, low = _heads(comp, inbits, nbits, out_cap,
                                             multi_stream)
    with trace.stage("walk"):
        heads = tokenize.token_starts(delta, inbits[:, 0])
        del delta
    spad = _slot_width(nbits)
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


def _slots(real: torch.Tensor, length: torch.Tensor, low: torch.Tensor,
           nbits: int, spad: int):
    """(valid, length, low) of each 9-bit slot: the one real head of the
    group, by its bit, with its length and low bits kept apart (length <<
    12 leaves int32 past 2^19); length 0 where the slot has none."""
    b = real.shape[0]
    at = torch.arange(nbits, dtype=_I32, device=real.device)
    at = F.pad(torch.where(real, at, -1), (0, spad * 9 - nbits), value=-1)
    slot_at = at.reshape(b, spad, 9).amax(dim=2)
    del at
    valid = slot_at >= 0
    g = slot_at.clamp(min=0).long()
    return valid, torch.where(valid, length.gather(1, g), 0), low.gather(1, g)


def _expand_windows(opos: torch.Tensor, length: torch.Tensor,
                    low: torch.Tensor, kept: torch.Tensor, lens: list[int],
                    out: torch.Tensor, rows: list[int],
                    base: list[int]) -> None:
    """Write the records' output into out[rows[i], base[i]:base[i] +
    lens[i]] (opos counts from base[i]), in windows of ``_ROW`` bytes,
    each the one-row fill (K8) and expansion (K17) of:

      * ``_HIST`` literal records, the ``_HIST`` bytes of ``out`` before
        the window (zeros before the row's start, which read as the
        sources before the block start do);
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
    nwin = -(-max(lens, default=0) // new)
    if nwin == 0:
        return
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
        bounds = bounds.cpu().tolist()
    for i, r in enumerate(rows):
        for k in range(-(-lens[i] // new)):
            start, a, e = k * new, bounds[i][k], bounds[i][k + 1]
            at = base[i] + start
            # zeros before the row's start
            hist = F.pad(out[r, max(at - _HIST, 0):at],
                         (max(_HIST - at, 0), 0))
            rec = torch.cat([
                hist_at | hist.to(_I32), head[i, k:k + 1],
                torch.where(kept[i, a:e],
                            ((opos[i, a:e] - (start - _HIST)) << 13)
                            | low[i, a:e], -1)])
            with trace.stage("raw_fill"):
                fill = pext.cummax_rows(rec[None].contiguous())
            take = min(new, lens[i] - start)
            n = torch.full((1,), _HIST + take, dtype=_I32, device=dev)
            with trace.stage("raw_expand"):
                got, _ = pexpand.expand_records(fill, n, _ROW)
            out[r, at:at + take] = got[0, _HIST:_HIST + take]


def _final(t: torch.Tensor, delta: torch.Tensor, head_ok: torch.Tensor,
           length: torch.Tensor, nbits: int, new: int, entry: torch.Tensor,
           left: torch.Tensor, ends_in: torch.Tensor) -> torch.Tensor:
    """bool[B, nbits]: the heads that a span of nbits // 8 bytes decides.

    A head's fields, its extension nibbles and its fit read the 32 bits
    from it (``_bit_windows``) and its chain, all inside the span, so a
    head that starts in the window's ``new`` bytes and whose successor
    starts 32 bits or more before the span's end is decided, and so is
    an end marker there (the chain ends or, in multi-stream mode, goes on
    from the next byte). A chain cut by the span's end reads as ended,
    but its successor then lies past the span. The entry head is also
    decided where even its cut chain fills what is ``left`` of the
    output. Where the row ends inside the span (``ends_in``) every head
    is decided, starvation included: its input fit reads the row's true
    length.
    """
    exact = t + 32 <= nbits
    fin = (t < 8 * new) & ((t + delta + 32 <= nbits)
                           | (exact & head_ok & (length == 0)))
    fin |= (t == entry[:, None]) & head_ok & (length >= left[:, None])
    return fin | ends_in[:, None]


def _cut(first: torch.Tensor, new: int, delta: torch.Tensor,
         length: torch.Tensor, low: torch.Tensor, head_ok: torch.Tensor,
         carried: torch.Tensor):
    """Where a window cuts its entry head, if it cannot decide it.

    Such an entry's run of 15-nibbles passes the span (with a margin of 8
    bytes or more, nothing else leaves it undecided): it is a copy with
    length code 1111 (len_init 8), or a continuation (``carried``,
    len_init 0), whose chain starts at ``first`` plus the head's width
    (none for a continuation) and holds ``runs`` 15-nibbles in the span
    (its length is len_init + 15 * runs + the nibble that ends the chain
    as read). The cut is a nibble boundary of the chain at or before bit
    8 * new (one nibble into the chain where the window's new bytes end
    before the chain starts): the entry emits len_init + 15 per nibble
    before it, and the next window's entry is the cut, a continuation of
    the same offset.

    Slot compaction: ``_slots`` keeps one head per 9 bits, and the
    continuation at bit ``first`` (< 8) of the next span has its
    successor 4 * (k + 1) bits on, k its 15-nibbles: one nibble and its
    end would put it in the same slot. The cut leaves ``_CUT_KEEP`` 15-
    nibbles of the span after it (the successor then lies 16 bits on or
    more). An entry is undecided only where its chain ends within 36 bits
    of the span's end, so a margin of 8 bytes or more leaves that many;
    ``ok`` is False where the entry is no such copy or leaves fewer.

    Returns (the cut's bit, the entry's length before it, the entry's
    offset, ok), int32/bool[B].
    """
    f = first[:, None].long()
    d, n, lo, fits = (x.gather(1, f)[:, 0] for x in (delta, length, low,
                                                       head_ok))
    init = torch.where(carried, 0, 8).to(_I32)
    runs = (n - init) // 15
    start = first + d - 4 * (runs + 1)
    take = ((8 * new - start) // 4).clamp(min=1)
    ok = (fits & (lo >> 11 == 1) & (n >= init)
          & (runs - take >= _CUT_KEEP))
    return start + 4 * take, init + 15 * take, lo & 0x7FF, ok


def _window_loop(comp: torch.Tensor, inbytes: list[int], cap: int | None,
                 multi_stream: bool, emit) -> tuple[list[int], list[int]]:
    """Decode the rows of comp (uint8/int32[B, C]) in windows of the
    input; returns the rows' (out_len, end_markers) as host ints.

    Each row carries its entry head's absolute bit (bit 0 first), its
    output base, its marker count and, where its entry continues a
    token, that copy's offset (else -1) on the host. A window takes the
    rows still decoding, ``_WIN`` new bytes over them, and reads each
    row's span from its entry's byte, at most ``_MARGIN`` bytes past the
    new ones: steps 1-4 of the module docstring on the span (the walk
    from the entry's bit in that byte), of which ``_final``'s heads make
    the window's records, their output offsets local cumsums (K9).
    ``emit(rows, base, opos, length, low, kept, lens)`` then expands them
    (``lens``: each row's output bytes, the records' total cut at what
    is left of ``cap``; None: no cap). A row is done when its chain ends
    in a window or its output reaches cap.

    An entry whose run of extension nibbles passes the span is cut
    (``_cut``): the window emits the part before the cut as a copy
    record, and the next window enters the run at the cut. A token of
    any length thus becomes one record per window, each of whose sums
    stays in int32, and its total lives only in the host's ``base``. A
    continuation's record starts at the next window's output base, which
    the expansion reads from the ``_HIST`` bytes before it: a copy of
    offset d is d-periodic, so the restart is exact (d < ``_HIST``).
    Where the input ends in the run (``ends_in``), the window decides
    the entry as one pass does: len_init (none for a continuation) plus
    its whole nibbles, and the chain ends. An end marker after a
    continued token jumps to the byte boundary one pass jumps to, and
    the next stream starts there: a span starts at a byte of the input. Under a cap, an entry whose
    cut run already fills what is left is decided as it stands
    (``_final``). A window that decides no head of a row and cannot cut
    its entry is a fault of this loop: it raises.
    """
    assert _MARGIN >= 8, "a span's margin must hold an entry's successor"
    b, c0 = comp.shape
    dev = comp.device
    # the bytes a row's walk reads: as in one pass over the padded input
    ends = [min(n, _padded(c0)) for n in inbytes]
    entry, base, markers = [0] * b, [0] * b, [0] * b
    carry = [-1] * b
    active = [r for r in range(b) if ends[r] > 0]
    while active:
        new = max(_WIN // len(active), 1)
        at = [entry[r] >> 3 for r in active]
        span = min(new + _MARGIN,
                   max(ends[r] - e for r, e in zip(active, at)))
        assert span <= MAX_WIDE_INPUT, "a span's sums leave int32"
        nbits = span * 8
        rows = torch.stack([F.pad(comp[r, e:e + span],
                                  (0, span - max(min(c0 - e, span), 0)))
                            for r, e in zip(active, at)])
        left = [_NO_CAP if cap is None else min(cap - base[r], _NO_CAP)
                for r in active]
        # per row: its input bits from the span's start (past the span
        # read as going on), the walk's length, the entry's bit, what is
        # left of the output, whether the row ends in the span, and the
        # offset of the copy that its entry continues (-1: none)
        per = torch.tensor(
            [[8 * min(inbytes[r] - e, span + 4), 8 * min(ends[r] - e, span),
              entry[r] & 7, lf, int(ends[r] - e <= span), carry[r]]
             for r, e, lf in zip(active, at, left)],
            dtype=_I32).to(dev)
        inbits, nwalk, first, lefts, ends_in, offset = per.unbind(1)
        carried = offset >= 0
        with trace.stage("heads"):
            delta, head_ok, length, low = _heads(
                rows, inbits[:, None], nbits,
                _NO_CAP if cap is None else cap, multi_stream,
                (first, offset) if any(carry[r] >= 0 for r in active)
                else None)
            del rows
        with trace.stage("walk"):
            # the walk starts at bit 0: its first step goes to the entry
            # (bit 0 is then no head of the orbit, so _final never reads
            # its step)
            delta[:, 0] = torch.where(first > 0, first, delta[:, 0])
            heads = tokenize.token_starts(delta, nwalk)
        with trace.stage("records"):
            t = torch.arange(nbits, dtype=_I32, device=dev)[None]
            orbit = heads & (t >= first[:, None])
            del heads
            fin = _final(t, delta, head_ok, length, nbits, new, first,
                         lefts, ends_in.bool())
            # the next window's entry: the first head not decided here,
            # or the cut of an entry that the span cannot decide, which
            # the window then emits up to the cut
            nxt = torch.where(orbit & ~fin, t, nbits).amin(dim=1)
            stuck = nxt == first
            cut, part, off, ok = _cut(first, new, delta, length, low,
                                      head_ok, carried)
            del delta
            f = first[:, None].long()
            length.scatter_(1, f, torch.where(
                stuck, part, length.gather(1, f)[:, 0])[:, None])
            fin.scatter_(1, f, stuck[:, None] | fin.gather(1, f))
            nxt = torch.where(stuck, cut, nxt)
            valid_s, len_s, low_s = _slots(orbit & fin & head_ok, length,
                                           low, nbits, _slot_width(nbits))
            del orbit, fin, head_ok, length, low
            opos = pext.cumsum_rows_wide(len_s) - len_s
            total = opos[:, -1] + len_s[:, -1]
            kept = valid_s & (opos < lefts[:, None])
            mk = (kept & (len_s == 0) & (low_s == 0)).sum(dim=1, dtype=_I32)
            got = torch.stack([nxt, torch.minimum(total, lefts), mk,
                               torch.where(stuck, off, -1),
                               (ok | ~stuck).to(_I32)],
                              dim=1).tolist()
        emit(active, [base[r] for r in active], opos, len_s, low_s, kept,
             [g[1] for g in got])
        still = []
        for r, e, (nx, n, m, off, good) in zip(active, at, got):
            if not good:
                raise RuntimeError(
                    f"internal: the input window at byte {e} decided no "
                    f"head of row {r} and cannot cut its entry")
            base[r] += n
            markers[r] += m
            if nx == nbits or (cap is not None and base[r] >= cap):
                continue
            entry[r] = 8 * e + nx
            carry[r] = off
            still.append(r)
        active = still
    return base, markers


def _decode_windows(comp: torch.Tensor, inbytes: torch.Tensor, out_cap: int,
                    multi_stream: bool):
    """``decode_batch_bits`` of rows wider than ``_WIN``: the window loop
    into one output row each, every window's records expanded at the
    row's output base behind the row's own bytes."""
    b = comp.shape[0]
    dev = comp.device
    out = torch.zeros((b, out_cap), dtype=torch.uint8, device=dev)

    def emit(rows, base, opos, length, low, kept, lens):
        _expand_windows(opos, length, low, kept, lens, out, rows, base)

    out_len, markers = _window_loop(comp, inbytes.tolist(), out_cap,
                                    multi_stream, emit)
    return (out, torch.tensor(out_len, dtype=_I32, device=dev),
            torch.tensor(markers, dtype=_I32, device=dev))


def decode_to_host(comp: torch.Tensor, *, multi_stream: bool = False
                   ) -> bytes:
    """Decode one raw stream (uint8[C], any C) with no output capacity:
    the window loop on one row, each window's output (its records'
    total, one host read) expanded on comp's device behind the last
    ``_HIST`` bytes before it and appended on the host."""
    dev = comp.device
    parts = []
    hist = torch.zeros((1, _HIST), dtype=torch.uint8, device=dev)

    def emit(rows, base, opos, length, low, kept, lens):
        nonlocal hist
        buf = torch.cat([hist, hist.new_zeros((1, lens[0]))], dim=1)
        _expand_windows(opos, length, low, kept, lens, buf, [0], [_HIST])
        parts.append(buf[0, _HIST:].cpu().numpy().tobytes())
        # a copy: a view would hold the window's whole output on the
        # device through the next window
        hist = buf[:, -_HIST:].clone()

    _window_loop(comp.reshape(1, -1), [comp.numel()], None, multi_stream,
                 emit)
    return b"".join(parts)
