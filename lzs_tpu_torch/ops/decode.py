"""Raw LZS stream decode (no container metadata), batched over streams.

Port of ``lzs_tpu.ops.decode``'s entry points with its default engine,
"bits": the parallel per-bit parse and chain walk of ``ops.bitpar``. The
JAX package's other engine, "scan" (a bit-serial ``lax.scan`` mirror of
the reference state machine, lzs-decompression.c:459-743, which JAX also
takes for outputs over ``bitpar.MAX_OUT_CAP``), is not ported yet: asking
for it raises ``NotImplementedError`` (ROADMAP Queue 1 item 1).

``max_units`` (the scan engine's parse-step budget, ``default_max_units``
when None) is taken where JAX takes it and passed on to ``decode_batch``,
whose scan branch is where it is read. Engine "bits" accepts it and does
not read it, as in JAX: the per-bit parse has no step budget.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import bitpar

_SCAN_TODO = ("the scan decoder (engine 'scan', and any out_cap over "
              f"{bitpar.MAX_OUT_CAP}) is not ported yet: ROADMAP Queue 1 "
              "item 1")


def default_max_units(out_cap: int) -> int:
    """Parse-step budget: every unit of a valid single stream produces at
    least one output byte, except one terminal zero-nibble per match token
    and the end marker."""
    return out_cap + out_cap // 2 + 8


def decode_batch(comp: torch.Tensor, inbytes: torch.Tensor, *,
                 out_cap: int, max_units: int | None = None,
                 multi_stream: bool = False, engine: str = "bits"):
    """Batched decode_block: (uint8[B, C], int32[B]) ->
    (uint8[B, out_cap], out_len int32[B], end_markers int32[B]).

    ``max_units`` is the scan engine's step budget; engine "bits" does not
    read it. bitpar buckets the input width to a multiple of 1 KiB, which
    JAX's decode_batch does here (for JAX it also reuses compiled
    programs).
    """
    if engine not in ("bits", "scan"):
        raise ValueError(f"unknown engine {engine!r}")
    if engine == "scan" or out_cap > bitpar.MAX_OUT_CAP:
        raise NotImplementedError(_SCAN_TODO)
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
                 multi_stream: bool = False):
    """Batch decoder: (uint8[B, in_cap], int32[B]) -> (uint8[B, out_cap],
    int32[B], int32[B]). ``in_cap`` is taken for the JAX signature and not
    read: any input width decodes; ``max_units`` goes to ``decode_batch``
    (engine "bits" does not read it)."""
    del in_cap
    return functools.partial(decode_batch, out_cap=out_cap,
                             max_units=max_units, multi_stream=multi_stream)


def decode_bytes(data: bytes, out_cap: int, *, multi_stream: bool = False,
                 device: torch.device | str = "cuda") -> bytes:
    """Host helper: decode a single stream on ``device`` (the CUDA card
    unless the caller names another)."""
    buf = torch.from_numpy(np.frombuffer(data, np.uint8).copy()).to(device)
    n = torch.tensor(len(data), dtype=torch.int32, device=buf.device)
    out, out_len, _ = decode_block(buf, n, out_cap=out_cap,
                                   multi_stream=multi_stream)
    return out[:int(out_len)].cpu().numpy().tobytes()
