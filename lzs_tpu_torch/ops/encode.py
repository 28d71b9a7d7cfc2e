"""Full LZS encode pipeline (bytes -> bitstream), batched over blocks.

Port of ``lzs_tpu.ops.encode``. Stages: best-match table (sortmatch,
or the exhaustive plane of ``match`` with ``backend="exhaustive"``; both
give the same bytes) -> token chain + emission units (tokenize) -> bit
pack with
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

import functools

import numpy as np
import torch

from .. import spec, trace
from . import bitpack, match, psync, sortmatch, tokenize

#: nibbles consumed per parse step inside an extension run (decode2
#: contract: a parse step sees >= 25 valid bits from one word fetch)
NIBBLES_PER_STEP = 6
#: default compressed-bit span between sync records; a multiple of 32
#: and > MAX_STEP_BITS
SYNC_SPAN = 2048
#: widest parse step in bits: a token head is <= 17, a 6-nibble group 24
MAX_STEP_BITS = 24
#: narrowest parse step in bits (a literal: flag + 8)
MIN_STEP_BITS = 9
#: match-search backends: "sort" (the fast path) and "exhaustive" (the
#: brute-force plane); both give the same bytes
BACKENDS = ("sort", "exhaustive")


def cap_bytes(block: int) -> int:
    """Static compressed-output capacity for a block of ``block`` bytes
    (multiple of 4, with slack for the word-granular packer)."""
    return (spec.compressed_max(block) + 11) & ~3


def sync_slots(block: int, span: int = SYNC_SPAN) -> int:
    """Static number of sync-record slots for a block."""
    return -(-(cap_bytes(block) * 8) // span) + 1


def sync_scan_len(span: int = SYNC_SPAN) -> int:
    """Static parse-step budget per decode lane for a given record span."""
    return -(-(span + MAX_STEP_BITS) // MIN_STEP_BITS) + 1


def _pipeline_batch(x: torch.Tensor, n: torch.Tensor, window: int, cap: int,
                    backend: str = "sort", policy: str = "greedy",
                    start: torch.Tensor | None = None):
    """Batched encode pipeline: x (B, N) bytes, n int32[B]; ``start``
    (int32[B] or None) is where each row's parse begins (see
    ``encode_batch``)."""
    x = x.to(torch.int32)
    npos = x.shape[1]
    if backend == "sort":
        score, off, full = sortmatch.best_matches_batch(x, n, window=window,
                                                        cap=cap)
    elif backend == "exhaustive":
        score, off, full = match.best_matches_batch(x, n, window=window,
                                                    cap=cap)
    else:
        raise ValueError(f"unknown backend {backend!r}")
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
            x, n, score, off, full, start)
    with trace.stage("pack"):
        comp, total_bits, offs = bitpack.pack_bits_batch(
            value, width, cap_bytes(npos),
            end_marker=(spec.END_MARKER_VALUE, spec.END_MARKER_BITS))
    nbytes = (total_bits + 7) >> 3
    return comp, nbytes, total_bits, offs, width, starts, off


def encode_block(x: torch.Tensor, n: torch.Tensor, *,
                 window: int = spec.WINDOW_SIZE,
                 cap: int = spec.SEARCH_MATCH_MAX, backend: str = "sort",
                 policy: str = "greedy"):
    """Encode one block: x uint8/int32[N] (only the first ``n`` bytes
    matter), n an int32 scalar tensor -> (comp uint8[cap_bytes(N)],
    nbytes int32 scalar): the stream with its end marker, zero-padded to a
    byte boundary."""
    comp, nbytes = encode_batch(x[None], n.reshape(1), window=window,
                                cap=cap, backend=backend, policy=policy)
    return comp[0], nbytes[0]


def encode_batch(x: torch.Tensor, n: torch.Tensor, *,
                 window: int = spec.WINDOW_SIZE,
                 cap: int = spec.SEARCH_MATCH_MAX, backend: str = "sort",
                 policy: str = "greedy", start: torch.Tensor | None = None):
    """(uint8[B, N], int32[B]) -> (uint8[B, cap_bytes(N)], int32[B]).

    ``backend`` is "sort" or "exhaustive" (same bytes); ``policy`` is
    "greedy" (the C encoder's bytes) or "lazy" (1-token lookahead). JAX's
    ``chunk`` has no counterpart: the exhaustive plane's fold width is
    ``match.FOLD``, and the bytes do not depend on it.

    ``start`` (int32[B], 0 <= start <= n, on x's device) opens each row
    with a carried history of that many bytes: they are match sources for
    the bytes after them (up to ``window`` back) and emit no token, so
    row b's stream encodes x[b, start:n] against them. None (or zeros)
    gives the stateless bytes.
    """
    return _pipeline_batch(x, n, window, cap, backend, policy, start)[:2]


def encode_block_sync(x: torch.Tensor, n: torch.Tensor, *,
                      window: int = spec.WINDOW_SIZE,
                      cap: int = spec.SEARCH_MATCH_MAX,
                      backend: str = "sort", span: int = SYNC_SPAN):
    """One block of ``encode_batch_sync`` (see there for the record
    contract): (comp, nbytes, sync_bit, sync_out, nsync) without the
    batch axis."""
    out = encode_batch_sync(x[None], n.reshape(1), window=window, cap=cap,
                            backend=backend, span=span)
    return tuple(o[0] for o in out)


def encode_batch_sync(x: torch.Tensor, n: torch.Tensor, *,
                      window: int = spec.WINDOW_SIZE,
                      cap: int = spec.SEARCH_MATCH_MAX,
                      backend: str = "sort", span: int = SYNC_SPAN,
                      policy: str = "greedy"):
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
        x, n, window, cap, backend, policy)
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


def make_encoder(*, window: int = spec.WINDOW_SIZE,
                 cap: int = spec.SEARCH_MATCH_MAX, backend: str = "sort",
                 sync: bool = False, span: int = SYNC_SPAN,
                 policy: str = "greedy"):
    """Batch encoder: (uint8[B, N], int32[B]) -> (uint8[B, cap_bytes(N)],
    int32[B]), plus (sync_bit, sync_out, nsync) when ``sync``. JAX's
    ``block`` and ``chunk`` have no counterpart: the rows' width is the
    block, and the bytes do not depend on the fold width."""
    if sync:
        return functools.partial(encode_batch_sync, window=window, cap=cap,
                                 backend=backend, span=span, policy=policy)
    return functools.partial(encode_batch, window=window, cap=cap,
                             backend=backend, policy=policy)


def encode_bytes(data: bytes, block: int = 1 << 15, *,
                 device: torch.device | str = "cuda") -> bytes:
    """Host helper: encode a byte string as one stream per ``block``
    bytes, concatenated (each an independent LZS stream with its end
    marker), on ``device`` (the CUDA card unless the caller names
    another)."""
    out = bytearray()
    for start in range(0, max(len(data), 1), block):
        piece = data[start:start + block]
        x = np.zeros(block, np.uint8)
        x[:len(piece)] = np.frombuffer(piece, np.uint8)
        xt = torch.from_numpy(x).to(device)
        n = torch.tensor(len(piece), dtype=torch.int32, device=xt.device)
        comp, nbytes = encode_block(xt, n)
        out += comp[:int(nbytes)].cpu().numpy().tobytes()
    return bytes(out)
