"""Greedy token-chain resolution and per-position emission units.

Port of ``lzs_tpu.ops.tokenize``: the token walk is ``pwalk.walk_starts``
(in-tile pointer doubling, a tile-serial entry thread, descent marking;
kernels K11-K13 on the card), batched over blocks; the two ownership
scans of ``emission_units_batch`` run on the port's row-scan kernels
(pext).

Every token start carries its head unit (flag + literal, or flag +
offset + initial length code, <= 18 bits); extension nibbles of a long
match are carried by the positions inside the match (position
start+1+t carries nibble t), so every position emits at most one
bounded-width unit. Positions stay int32 throughout.
"""

from __future__ import annotations

import torch

from .. import spec
from . import pext, pwalk

_BIG = 0x3FFFFFFF


def token_starts(step: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """bool[B, N]: True at greedy token starts.

    step: int32[B, N] bytes consumed by a token starting at each position
    (>= 1 wherever i < n); n: int32[B].

    The pwalk token walk: its three kernels on a CUDA tensor (as the JAX
    package runs ``pwalk.walk_starts`` on its accelerator), their plain
    versions on a CPU tensor.
    """
    return pwalk.walk_starts(step, n)


def emission_units_batch(x: torch.Tensor, n: torch.Tensor,
                         score: torch.Tensor, off: torch.Tensor,
                         full: torch.Tensor,
                         start: torch.Tensor | None = None):
    """Per-position emission units over (B, N) arrays.

    ``start`` (int32[B], 0 <= start <= n, or None for all 0) is where each
    row's parse begins: the bytes before it are a carried history, match
    sources that emit nothing. The walk treats them as one token from
    position 0 to ``start``, and that token's start is dropped.

    Returns (value, width, starts, length): int32 value/width (width 0
    emits nothing), bool token-start flags, int32 token length at starts
    (1 for literals).
    """
    b, npos = x.shape
    i = torch.arange(npos, dtype=torch.int32, device=x.device).expand(b, npos)
    nq = n[:, None]
    is_match = (score >= spec.MIN_MATCH) & (i < nq)
    length = torch.where(is_match, full, 1)
    step = torch.where(i < nq, length, 1)
    if start is not None:
        step[:, 0] = torch.where(start > 0, start, step[:, 0])
    starts = token_starts(step, n)
    del step
    if start is not None:
        starts &= i >= start[:, None]

    # head units: length code by arithmetic (lzs-compression.c:91-124)
    initial = length.clamp(max=spec.MAX_SHORT_LENGTH).clamp(2, 8)
    short_code = initial < 5
    lv = torch.where(short_code, initial - 2, initial + 7)
    lw = torch.where(short_code, 2, 4)
    short = off <= spec.SHORT_OFFSET_MAX
    off_field = torch.where(short, (1 << spec.SHORT_OFFSET_BITS) | off, off)
    off_width = torch.where(short, 1 + spec.SHORT_OFFSET_BITS,
                            1 + spec.LONG_OFFSET_BITS).to(torch.int32)
    match_v = (((1 << off_width) | off_field) << lw) | lv
    match_w = 1 + off_width + lw
    head_v = torch.where(is_match, match_v, x.to(torch.int32))
    head_w = torch.where(is_match, match_w, 9)

    # gather-free ownership: owner start and next start by row scans
    key = torch.where(starts, (i << 1) | is_match.to(torch.int32), -1)
    ck = pext.cummax_rows(key)
    owner = ck >> 1
    own_match = (ck & 1) == 1
    nstart = torch.where(starts, i, _BIG)
    rc = pext.rcummin_rows(nstart)                   # next start >= j
    own_len = torch.minimum(rc, nq) - owner          # token length at j

    # extension nibbles attributed to in-match positions
    t = i - owner - 1
    rest = own_len - spec.MAX_SHORT_LENGTH
    q = torch.div(rest.clamp(min=0), spec.MAX_EXTENDED_LENGTH,
                  rounding_mode="floor")
    is_nib = ((~starts) & (owner >= 0) & own_match
              & (own_len >= spec.MAX_SHORT_LENGTH)
              & (t < q + 1) & (i < nq))
    nib_v = torch.where(t < q, spec.MAX_EXTENDED_LENGTH,
                        rest - q * spec.MAX_EXTENDED_LENGTH)

    value = torch.where(starts, head_v, torch.where(is_nib, nib_v, 0))
    width = torch.where(starts, head_w, torch.where(is_nib, 4, 0))
    return (value.to(torch.int32), width.to(torch.int32), starts,
            length.to(torch.int32))


def emission_units(x: torch.Tensor, n: torch.Tensor, score: torch.Tensor,
                   off: torch.Tensor, full: torch.Tensor):
    """One block of ``emission_units_batch``: [N] arrays and an int32
    scalar tensor n -> (value, width, starts, length), [N] each."""
    out = emission_units_batch(x[None], n.reshape(1), score[None],
                               off[None], full[None])
    return tuple(o[0] for o in out)
