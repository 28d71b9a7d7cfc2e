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
    value int32[B, nbits] the head's slot value length << 12 | is_copy
    << 11 | payload, 0 for an end marker)."""
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
    # length <= 2^18 keeps the value positive; an end marker is the one
    # all-zero value (length 0, literal flag, payload = offset 0)
    value = (length << 12) | (is_match.to(_I32) << 11) | payload
    return delta.to(_I32), head_ok, value.to(_I32)


def decode_batch_bits(comp: torch.Tensor, inbytes: torch.Tensor, *,
                      out_cap: int, multi_stream: bool = False):
    """Parallel decode of a batch of raw LZS streams.

    comp: uint8/int32[B, C] compressed bytes (zero padding past
    ``inbytes`` is fine); inbytes: int32[B] valid input lengths; out_cap:
    output capacity in bytes (<= 2**18); multi_stream: continue across
    end markers (incremental semantics) instead of stopping at the first.

    Returns (out uint8[B, out_cap], out_len int32[B], end_markers
    int32[B]), the contract of ``decode.decode_batch``.
    """
    if not 0 < out_cap <= MAX_OUT_CAP:
        raise ValueError(f"out_cap {out_cap} outside (0, {MAX_OUT_CAP}]: "
                         "records pack the output position as opos << 13")
    b, c0 = comp.shape
    # multiples of 1024 bytes, as in JAX (its walk's widest row block)
    cpad = max(-(-c0 // 1024) * 1024, 1024)
    nbits = cpad * 8
    inbits = inbytes.to(_I32)[:, None] * 8

    with trace.stage("heads"):
        delta, head_ok, value = _heads(comp, inbits, nbits, out_cap,
                                       multi_stream)
    with trace.stage("walk"):
        heads = tokenize.token_starts(delta, inbits[:, 0])
        del delta
    with trace.stage("records"):
        # slot compaction first: heads are >= 9 bits apart, so bit // 9 is
        # injective over them and a max over each 9-bit group keeps the
        # one head's value (-1 where there is none)
        packed = torch.where(heads & head_ok, value, -1)
        del heads, head_ok, value
        s9 = -(-nbits // 9)
        spad = max(-(-s9 // 128) * 128, _MIN_SLOTS)
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
