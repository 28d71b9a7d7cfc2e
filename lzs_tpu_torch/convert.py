"""Carry codec state between the JAX package and the port.

The codec has no weights: its state is its settings, the batch arrays
that pass between the encoder and the decoder, a stream's checkpoint and
a generalized codec's coders. These helpers move them without importing
jax: a JAX ``BlockCodec`` or ``GeneralCodec`` is read through its plain
attributes, batch arrays cross as numpy, and a stream checkpoint
(``state_dict()``, plain data) becomes the port's stream object.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import coders, stream
from .blocks import BlockCodec

#: batch arrays of the container path and the raw decoder, and their
#: dtypes
BATCH_DTYPES = {
    "comp": np.uint8,       # (B, cap) packed streams
    "clen": np.int32,       # (B,) compressed bytes per block
    "sync_bit": np.int32,   # (B, I) sync record bit offsets
    "sync_out": np.int32,   # (B, I) packed sync records
    "nsync": np.int32,      # (B,) live sync records per block
    "n": np.int32,          # (B,) decoded bytes per block
    "out_len": np.int32,    # (B,) raw decode: bytes decoded per stream
    "markers": np.int32,    # (B,) raw decode: end markers read per stream
}


def codec_from_jax(jax_codec,
                   device: torch.device | str = "cuda") -> BlockCodec:
    """The port's BlockCodec with a JAX codec's settings on ``device``
    (the CUDA card unless the caller names another).

    The JAX codec's ``chunk`` sizes only its brute-force search backend;
    its BlockCodec always uses the sort-based search, whose bytes do not
    depend on it, so ``chunk`` is checked and not carried.
    """
    if int(jax_codec.chunk) <= 0:
        raise ValueError(f"invalid chunk {jax_codec.chunk!r}")
    return BlockCodec(block=int(jax_codec.block), span=int(jax_codec.span),
                      policy=str(jax_codec.policy), device=device)


def batch_to_torch(arrays: dict[str, np.ndarray],
                   device: torch.device | str) -> dict[str, torch.Tensor]:
    """numpy (or array-like) batch arrays -> contiguous tensors on device."""
    out = {}
    for key, a in arrays.items():
        if key not in BATCH_DTYPES:
            raise KeyError(f"unknown batch array {key!r}")
        a = np.array(a, dtype=BATCH_DTYPES[key])    # a writable C copy
        out[key] = torch.from_numpy(a).to(device)
    return out


def batch_to_numpy(tensors: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """Tensors on any device -> numpy batch arrays of the container dtypes."""
    out = {}
    for key, t in tensors.items():
        if key not in BATCH_DTYPES:
            raise KeyError(f"unknown batch array {key!r}")
        out[key] = t.detach().cpu().numpy().astype(BATCH_DTYPES[key])
    return out


def stream_state_from_jax(state: dict, device: torch.device | str = "cuda"):
    """The port's ``StreamCompressor`` or ``StreamDecompressor`` resumed
    from a JAX stream object's ``state_dict()``: a stream begun in JAX
    goes on in the port with the same bytes.

    A compressor's match search runs on ``device`` (the CUDA card unless
    the caller names another); a decompressor is host code and does not
    read it. Raises KeyError unless the keys are exactly one class's JAX
    fields.
    """
    for cls, extra in ((stream.StreamCompressor, {"device": str(device)}),
                       (stream.StreamDecompressor, {})):
        fields = {f.name for f in dataclasses.fields(cls)} - set(extra)
        if set(state) == fields:
            return cls(**state, **extra)
    raise KeyError(f"not a JAX stream state: keys {sorted(state)}")


#: the coder classes that ``general_codec_from_jax`` carries across
_CODERS = ("StandardOffsetCoder", "BiasedOffsetCoder", "FixedOffsetCoder",
           "PrefixLengthCoder")


def _plain_ints(v):
    """An int, or nested tuples of ints, as Python ints."""
    return tuple(map(_plain_ints, v)) if isinstance(v, tuple) else int(v)


def _coder_from_jax(coder):
    name = type(coder).__name__
    if name not in _CODERS:
        raise TypeError(f"not a JAX coder: {coder!r}")
    cls = getattr(coders, name)
    return cls(**{f.name: _plain_ints(getattr(coder, f.name))
                  for f in dataclasses.fields(cls)})


def general_codec_from_jax(codec, *,
                           device: torch.device | str = "cuda"
                           ) -> coders.GeneralCodec:
    """The port's GeneralCodec with a JAX ``GeneralCodec``'s coders, field
    by field, its match search on ``device`` (the CUDA card unless the
    caller names another)."""
    return coders.GeneralCodec(_coder_from_jax(codec.offset_coder),
                               _coder_from_jax(codec.length_coder),
                               device=str(device))
