"""Sync-parallel LZS decode (the container path), batched over blocks.

Port of ``lzs_tpu.ops.decode2``. The container's sync records give the
parser state at the last parse point before every multiple of ``span``
compressed bits, so lane l of a block parses the statically located bit
range [span*l - 24, span*(l+1)) from its own tile of span/32 + 2 words
(carved out with reshapes only). The parse is word-fed: step s feeds
every lane column s of its tile, the lane keeps the last two words as a
64-bit register, and up to four tokens are parsed per fed word (the
densest legal packing). A substep consumes one token head (<= 17 bits)
or up to 6 extension nibbles (<= 24 bits), mirroring the incremental
decoder's states (lzs-decompression.c:505-739).

Each parsed token becomes one int32 record (opos << 13 | is_copy << 11
| payload); a running max fills the empty slots (pext, a kernel on the
card) and ``pexpand.expand_records`` (a kernel on the card) turns the
records into bytes.

On a CUDA tensor the lane parse launches ``csrc/parse.cu``, one thread
per (block, lane) carrying the parser state in registers through all
(span/32 + 2) x 4 substeps: ``_parse_full`` in JAX's step-major record
layout, ``_parse_flat`` (the decode's) lane-major, clamped and padded, so
that the fill is the cummax alone. On a CPU tensor each runs its plain
version, a torch loop over the same substeps on (B, lanes) tensors, with
uint32 word arithmetic on int64 masked to 32 bits.
"""

from __future__ import annotations

import torch

from .. import trace
from . import encode as enc
from . import _kernels, pexpand, pext
from .sortmatch import clz32

_SUBSTEPS = 4         # tokens parseable per fed 32-bit word
_RW = 768             # minimum filled-record row (the TPU record window)
_M32 = 0xFFFFFFFF
_EXT = 15             # MAX_EXTENDED_LENGTH


def _lane_tiles(comp: torch.Tensor, nslots: int, span: int) -> torch.Tensor:
    """comp: uint8[B, C] -> int64[B, nslots, wpl + 2] uint32 words with
    tile[b, l, s] = word[wpl*l - 1 + s] (out-of-range words are zero)."""
    b = comp.shape[0]
    wpl = span // 32
    nwords = nslots * wpl
    need = nwords * 4
    x = comp.to(torch.int64)
    if x.shape[1] < need:
        x = torch.cat([x, x.new_zeros((b, need - x.shape[1]))], dim=1)
    x = x[:, :need].reshape(b, nwords, 4)
    w = (x[..., 0] << 24) | (x[..., 1] << 16) | (x[..., 2] << 8) | x[..., 3]
    cur = w.reshape(b, nslots, wpl)
    prev = torch.cat([w.new_zeros((b, 1)), w[:, :-1]], dim=1)
    col0 = prev.reshape(b, nslots, wpl)[:, :, :1]
    nxt = torch.cat([cur[:, 1:, :1], w.new_zeros((b, 1, 1))], dim=1)
    return torch.cat([col0, cur, nxt], dim=2)


def _parse_substep(w, bitpos, outpos, mode, cur_off, can):
    """Decode one token at the top 24 bits of ``w`` (int64 uint32 values)
    for lanes where ``can``. Returns (record, bitpos, outpos, mode,
    cur_off); record = -1 where nothing was parsed or the token has zero
    output length."""
    i32 = torch.int32
    # NORMAL: one token head (lzs-decompression.c:214-343)
    is_lit = (w >> 31) == 0
    lit = ((w >> 23) & 0xFF).to(i32)
    short = ((w >> 30) & 1) == 1
    n_off = torch.where(short, (w >> 23) & 0x7F, (w >> 19) & 0x7FF).to(i32)
    l4 = torch.where(short, (w >> 19) & 0xF, (w >> 15) & 0xF).to(i32)
    long_len = (l4 >> 2) == 3
    len_init = torch.where(long_len, (l4 & 3) + 5, (l4 >> 2) + 2)
    lw = torch.where(long_len, 4, 2)
    n_len = torch.where(is_lit, 1, len_init)
    n_consume = torch.where(is_lit, 9, 1 + torch.where(short, 8, 12) + lw)
    n_mode = ((~is_lit) & long_len & ((l4 & 3) == 3)).to(i32)

    # EXTENDED: up to 6 nibbles (24 valid bits) in one substep
    # (lzs-decompression.c:713-730, batched)
    nf = (clz32((w ^ _M32) | 0xFF) >> 2).clamp(max=6)
    whole = nf >= 6
    term = ((w >> (28 - 4 * nf.clamp(max=5))) & 0xF).to(i32)
    nf = nf.to(i32)
    e_len = torch.where(whole, 6 * _EXT, _EXT * nf + term)
    e_consume = torch.where(whole, 24, 4 * (nf + 1))
    e_mode = whole.to(i32)

    is_ext = mode == 1
    is_copy = is_ext | ~is_lit
    payload = torch.where(is_ext, cur_off, torch.where(is_lit, lit, n_off))
    length = torch.where(is_ext, e_len, n_len)
    consume = torch.where(is_ext, e_consume, n_consume)
    rec = torch.where(can & (length > 0),
                      (outpos << 13) | (is_copy.to(i32) << 11) | payload, -1)
    bitpos = bitpos + torch.where(can, consume, 0).to(i32)
    outpos = outpos + torch.where(can, length, 0).to(i32)
    mode = torch.where(can, torch.where(is_ext, e_mode, n_mode), mode)
    cur_off = torch.where(can & ~is_ext & ~is_lit, n_off, cur_off)
    return rec.to(i32), bitpos, outpos, mode, cur_off


def _parse_full_plain(comp: torch.Tensor, sync_bit: torch.Tensor,
                      sync_out: torch.Tensor, span: int):
    """Plain-torch ``_parse_full`` (same results, any device)."""
    b, nslots = sync_bit.shape
    wpl = span // 32
    tile = _lane_tiles(comp, nslots, span)               # [B, L, wpl+2]
    end_bit = torch.cat([sync_bit[:, 1:], sync_bit[:, -1:]], dim=1)
    lane_word0 = (torch.arange(nslots, dtype=torch.int64,
                               device=comp.device) * wpl - 1)

    hi = torch.zeros((b, nslots), dtype=torch.int64, device=comp.device)
    lo = hi
    bitpos = sync_bit.to(torch.int32)
    outpos = sync_out & 0x1FFFF
    mode = (sync_out >> 17) & 1
    cur_off = sync_out >> 18
    recs = []
    for s in range(wpl + 2):
        hi, lo = lo, tile[:, :, s]
        ebits = (lane_word0 + s + 1) * 32    # bits fed so far (exclusive)
        for _ in range(_SUBSTEPS):
            sh = (bitpos - (ebits - 64)).clamp(0, 63)
            w = torch.where(
                sh < 32,
                ((hi << sh.clamp(max=31)) & _M32)
                | torch.where(sh == 0, 0, lo >> (32 - sh).clamp(0, 32)),
                (lo << (sh - 32).clamp(0, 31)) & _M32)
            can = (bitpos < end_bit) & (bitpos + enc.MAX_STEP_BITS <= ebits)
            rec, bitpos, outpos, mode, cur_off = _parse_substep(
                w, bitpos, outpos, mode, cur_off, can)
            recs.append(rec)
    return torch.stack(recs, dim=1), outpos


def _check_parse(comp: torch.Tensor, sync_bit: torch.Tensor,
                 sync_out: torch.Tensor) -> tuple[int, int]:
    """Validate the lane parse kernel's operands; returns (B, L)."""
    if comp.dim() != 2 or sync_bit.dim() != 2:
        raise ValueError(f"comp (B, C) and sync records (B, L) expected, "
                         f"got {tuple(comp.shape)} and "
                         f"{tuple(sync_bit.shape)}")
    b, nslots = sync_bit.shape
    _kernels.check(comp, "comp", torch.uint8, (b, comp.shape[1]))
    _kernels.check(sync_bit, "sync_bit", torch.int32)
    _kernels.check(sync_out, "sync_out", torch.int32, (b, nslots))
    return b, nslots


def _launch_parse(comp, sync_bit, sync_out, span, recs, width):
    """Run csrc/parse.cu into ``recs`` (width 0: JAX's step-major layout,
    else lane-major rows of ``width``); returns out_final."""
    b, nslots = sync_bit.shape
    out_final = torch.empty((b, nslots), dtype=torch.int32,
                            device=comp.device)
    if b and nslots:
        _kernels.PARSE.launch(comp.device, comp.data_ptr(),
                              sync_bit.data_ptr(), sync_out.data_ptr(), b,
                              comp.shape[1], nslots, span // 32,
                              recs.data_ptr(), width, out_final.data_ptr())
    return out_final


def _parse_full(comp: torch.Tensor, sync_bit: torch.Tensor,
                sync_out: torch.Tensor, span: int):
    """Lane-parallel token parse of a batch of block streams.

    comp: uint8[B, C]; sync_bit/sync_out: int32[B, L] sync records (bit
    offset; output offset bits 0-16 | mode bit 17 | match offset from bit
    18). Returns (recs int32[B, (span/32 + 2) * 4, L] records
    opos << 13 | is_copy << 11 | payload in step order, -1 for empty
    slots; out_final int32[B, L] each lane's final output position, which
    must equal the next lane's starting offset).
    """
    if _kernels.on_cpu(comp, sync_bit, sync_out):
        return _parse_full_plain(comp, sync_bit, sync_out, span)
    b, nslots = _check_parse(comp, sync_bit, sync_out)
    recs = torch.empty((b, (span // 32 + 2) * _SUBSTEPS, nslots),
                       dtype=torch.int32, device=comp.device)
    return recs, _launch_parse(comp, sync_bit, sync_out, span, recs, 0)


def _flat_width(records: int) -> int:
    """Slots of a lane-major row of ``records`` records: padded to a
    multiple of 128, at least 768 (the TPU form's shape)."""
    return max((records + 127) & ~127, _RW)


def _flat_records(recs: torch.Tensor) -> torch.Tensor:
    """int32[B, S, L] step-major records -> the fill's input: lane-major
    int32[B, _flat_width(S * L)] rows, records below 0 as -1, padded with -1."""
    b, steps, nslots = recs.shape
    flat = recs.transpose(1, 2).reshape(b, -1)
    want = _flat_width(steps * nslots)
    if want != flat.shape[1]:
        flat = torch.cat([flat, flat.new_full((b, want - flat.shape[1]),
                                              -1)], dim=1)
    return torch.where(flat >= 0, flat, -1).contiguous()


def _parse_flat_plain(comp: torch.Tensor, sync_bit: torch.Tensor,
                      sync_out: torch.Tensor, span: int):
    """Plain-torch ``_parse_flat``: ``_parse_full_plain``, then the
    transpose, the pad and the clamp (any device)."""
    recs, out_final = _parse_full_plain(comp, sync_bit, sync_out, span)
    return _flat_records(recs), out_final


def _parse_flat(comp: torch.Tensor, sync_bit: torch.Tensor,
                sync_out: torch.Tensor, span: int):
    """The lane parse in the form the record fill takes: (flat
    int32[B, _flat_width(L * S)], out_final int32[B, L]).

    flat[b, l*S + 4*s + k] is ``_parse_full``'s record of substep k of
    step s of lane l (S = 4 * (span/32 + 2)), any record below 0 as -1,
    and -1 past L * S: what ``_filled_records`` hands the cummax. On a
    CUDA tensor one launch of csrc/parse.cu writes it all.
    """
    if _kernels.on_cpu(comp, sync_bit, sync_out):
        return _parse_flat_plain(comp, sync_bit, sync_out, span)
    b, nslots = _check_parse(comp, sync_bit, sync_out)
    width = _flat_width(nslots * (span // 32 + 2) * _SUBSTEPS)
    flat = torch.empty((b, width), dtype=torch.int32, device=comp.device)
    if not nslots:                  # no lanes: the kernel does not run
        flat.fill_(-1)
    return flat, _launch_parse(comp, sync_bit, sync_out, span, flat, width)


def _filled_records(recs: torch.Tensor) -> torch.Tensor:
    """Lane-major record stream, cummax-filled for the record walk.

    recs: int32[B, S, L] parse records (-1 empty), JAX's layout. Records
    have strictly increasing output positions in lane-major order, so a
    running max fills every empty slot with the previous record. Padded
    with -1 to a multiple of 128 slots (at least 768, the TPU form's
    shape). The decode itself takes ``_parse_flat``'s rows, which are
    ``_flat_records(recs)`` already.
    """
    return pext.cummax_rows(_flat_records(recs))


def decode_block_sync(comp: torch.Tensor, sync_bit: torch.Tensor,
                      sync_out: torch.Tensor, n: torch.Tensor, *,
                      out_cap: int, span: int = enc.SYNC_SPAN):
    """Decode one container block: comp uint8[C], sync_bit/sync_out
    int32[I] from ``encode.encode_block_sync``, n an int32 scalar tensor
    -> uint8[out_cap] (zero past ``n``; see ``decode_batch_sync`` for the
    status variant)."""
    out, _ = decode_batch_sync(comp[None], sync_bit[None], sync_out[None],
                               n.reshape(1), out_cap=out_cap, span=span)
    return out[0]


def decode_batch_sync(comp: torch.Tensor, sync_bit: torch.Tensor,
                      sync_out: torch.Tensor, n: torch.Tensor, *,
                      out_cap: int, span: int = enc.SYNC_SPAN):
    """Batched sync-parallel decode with per-block status words.

    comp: uint8[B, C]; sync_bit/sync_out: int32[B, I]; n: int32[B].
    JAX's ``chunk``, which it does not read either, has no counterpart.
    Returns (out uint8[B, out_cap], status int32[B]); status bits:
      bit 0  a byte inside [0, n) had no covering token
      bit 1  a copy source fell before the block start (zero-filled)
      bit 2  a parse lane's final output position disagrees with the
             next lane's sync record (corrupt stream or records)
    0 means the block decoded cleanly.
    """
    with trace.stage("parse"):
        flat, out_final = _parse_flat(comp, sync_bit, sync_out, span)
    with trace.stage("fill"):
        fill = pext.cummax_rows(flat)
    with trace.stage("expand"):
        out, status = pexpand.expand_records(fill, n.to(torch.int32),
                                             out_cap)
    nxt = torch.cat([sync_out[:, 1:] & 0x1FFFF, n[:, None]], dim=1)
    bad = (out_final != nxt).any(dim=1)
    return out, status | (bad.to(torch.int32) << 2)


def make_decoder_sync(out_cap: int, *, span: int = enc.SYNC_SPAN):
    """Batch decoder over container blocks with sync records: (comp,
    sync_bit, sync_out, n) -> uint8[B, out_cap], bytes only (see
    ``decode_batch_sync`` for the status variant). JAX's ``in_cap`` has no
    counterpart: the input's width is comp's."""

    def fn(comp, sync_bit, sync_out, n):
        return decode_batch_sync(comp, sync_bit, sync_out, n,
                                 out_cap=out_cap, span=span)[0]

    return fn
