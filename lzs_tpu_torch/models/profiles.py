"""Named codec profiles built on the generalized coder layer (port of
``lzs_tpu.models.profiles``: the same 12 names and coders)."""

from __future__ import annotations

import dataclasses

from ..coders import (BiasedOffsetCoder, FixedOffsetCoder, GeneralCodec,
                      LENGTH_CODER_PRESETS, StandardOffsetCoder)

PROFILES = {
    # the ANSI X3.241 / RFC 1967 wire format
    "standard": GeneralCodec(StandardOffsetCoder(7, 11),
                             LENGTH_CODER_PRESETS["standard"]),
    # extended-reach offsets (biased long range)
    "reach": GeneralCodec(BiasedOffsetCoder(7, 11),
                          LENGTH_CODER_PRESETS["standard"]),
    # flat 12-bit offsets + flat 4-bit lengths (simple hardware profile)
    "flat": GeneralCodec(FixedOffsetCoder(12),
                         LENGTH_CODER_PRESETS["flat4"]),
    # flat offsets, no length continuation (bounded-token profile)
    "bounded": GeneralCodec(FixedOffsetCoder(12),
                            LENGTH_CODER_PRESETS["flat4_noext"]),
    # deep-initial-length prefix code with 2-bit continuation
    "deep": GeneralCodec(StandardOffsetCoder(7, 11),
                         LENGTH_CODER_PRESETS["deep"]),
    # the reference python framework's experimental length coders
    # (python/lzs.py:343-641), wire-exact
    **{f"ref-{k}": GeneralCodec(StandardOffsetCoder(7, 11),
                                LENGTH_CODER_PRESETS[k])
       for k in ("lc2", "lc3", "lc4", "lc5", "lc6", "lc7", "lc8")},
}


def get_profile(name: str, device: str = "cuda") -> GeneralCodec:
    """The named profile with its match search on ``device`` (the CUDA
    card unless the caller names another)."""
    try:
        codec = PROFILES[name]
    except KeyError:
        raise KeyError(
            f"unknown profile {name!r}; available: {sorted(PROFILES)}")
    return dataclasses.replace(codec, device=device)
