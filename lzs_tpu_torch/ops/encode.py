"""Full LZS encode pipeline (bytes -> bitstream), batched over blocks.

Port of ``lzs_tpu.ops.encode`` (sort backend). Stages: best-match table
(sortmatch) -> token chain + emission units (tokenize) -> bit pack with
the end marker (bitpack; a kernel on the card) -> decode sync records
(psync; a kernel on the card). Output is byte-identical to the
reference C encoders (greedy policy) and to the JAX package.

Sync records: parser-state records at the last parse point before
every multiple of ``span`` compressed bits, so the container decoder
(decode2) parses one stream in many independent lanes over statically
located stream tiles. Records live in the container framing only; the
LZS payload stays reference-compatible.
"""

from __future__ import annotations

import torch

from .. import spec, trace
from . import bitpack, psync, sortmatch, tokenize

#: nibbles consumed per parse step inside an extension run (decode2
#: contract: a parse step sees >= 25 valid bits from one word fetch)
NIBBLES_PER_STEP = 6
#: default compressed-bit span between sync records; a multiple of 32
#: and > MAX_STEP_BITS
SYNC_SPAN = 2048
#: widest parse step in bits: a token head is <= 17, a 6-nibble group 24
MAX_STEP_BITS = 24


def cap_bytes(block: int) -> int:
    """Static compressed-output capacity for a block of ``block`` bytes
    (multiple of 4, with slack for the word-granular packer)."""
    return (spec.compressed_max(block) + 11) & ~3


def sync_slots(block: int, span: int = SYNC_SPAN) -> int:
    """Static number of sync-record slots for a block."""
    return -(-(cap_bytes(block) * 8) // span) + 1


def _pipeline_batch(x: torch.Tensor, n: torch.Tensor, window: int, cap: int,
                    policy: str = "greedy"):
    """Batched encode pipeline: x (B, N) bytes, n int32[B]."""
    x = x.to(torch.int32)
    npos = x.shape[1]
    score, off, full = sortmatch.best_matches_batch(x, n, window=window,
                                                    cap=cap)
    if policy == "lazy":
        # 1-token lookahead: defer a match when the next position holds
        # a strictly longer one and emit a literal instead (streams stay
        # valid LZS; byte parity with the C encoder is greedy-only)
        is_m = score >= spec.MIN_MATCH
        nxt_m = torch.cat([is_m[:, 1:], torch.zeros_like(is_m[:, :1])], 1)
        nxt_full = torch.cat([full[:, 1:], torch.zeros_like(full[:, :1])], 1)
        defer = is_m & nxt_m & (nxt_full > full)
        score = torch.where(defer, 0, score)
        full = torch.where(defer, 1, full)
    elif policy != "greedy":
        raise ValueError(f"unknown policy {policy!r}")
    with trace.stage("units"):
        value, width, starts, _ = tokenize.emission_units_batch(
            x, n, score, off, full)
    with trace.stage("pack"):
        comp, total_bits, offs = bitpack.pack_bits_batch(
            value, width, cap_bytes(npos),
            end_marker=(spec.END_MARKER_VALUE, spec.END_MARKER_BITS))
    nbytes = (total_bits + 7) >> 3
    return comp, nbytes, total_bits, offs, width, starts, off


def encode_batch(x: torch.Tensor, n: torch.Tensor, *,
                 window: int = spec.WINDOW_SIZE,
                 cap: int = spec.SEARCH_MATCH_MAX, policy: str = "greedy"):
    """(uint8[B, N], int32[B]) -> (uint8[B, cap_bytes(N)], int32[B])."""
    return _pipeline_batch(x, n, window, cap, policy)[:2]


def encode_batch_sync(x: torch.Tensor, n: torch.Tensor, *,
                      window: int = spec.WINDOW_SIZE,
                      cap: int = spec.SEARCH_MATCH_MAX,
                      span: int = SYNC_SPAN, policy: str = "greedy"):
    """Encode and emit parse sync records.

    Returns (comp uint8[B, cap], nbytes int32[B], sync_bit int32[B, I],
    sync_out int32[B, I], nsync int32[B]). Slot l >= 1 holds the parser
    state at the last parse point before bit ``span * l``; slot 0 is the
    stream start; sync_out packs output byte offset (bits 0..16) | parser
    mode (bit 17) | current match offset (bits 18..28). Slots >= nsync
    hold the stream-end sentinel (total token bits, n).
    """
    if span % 32 or span <= MAX_STEP_BITS:
        raise ValueError(f"span {span} must be a multiple of 32 above "
                         f"{MAX_STEP_BITS}")
    comp, nbytes, total_bits, offs, width, starts, off = _pipeline_batch(
        x, n, window, cap, policy)
    with trace.stage("sync"):
        sync_bit, sync_out, nsync = _sync_records_batch(
            total_bits, offs, width, starts, off, n, span)
    return comp, nbytes, sync_bit, sync_out, nsync


def _sync_records_batch(total_bits, offs, width, starts, off, n, span):
    """(sync_bit, sync_out, nsync) from the packed units of a batch."""
    npos = starts.shape[1]
    end_bits = total_bits - spec.END_MARKER_BITS
    return psync.sync_records(
        starts, width[:, :npos].contiguous(), off.to(torch.int32),
        offs[:, :npos].contiguous(), end_bits, n.to(torch.int32),
        span=span, nibbles=NIBBLES_PER_STEP,
        short_len=spec.MAX_SHORT_LENGTH, ext_len=spec.MAX_EXTENDED_LENGTH,
        nslots=sync_slots(npos, span))
