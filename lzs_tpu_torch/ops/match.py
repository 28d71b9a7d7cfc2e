"""Exhaustive LZS match search (the brute-force windowed-compare plane).

Port of ``lzs_tpu.ops.match``. For every position i of a block, over
every offset d in [1, window]:

  score[i] = max over d of min(runlen(i, d), cap)
  off[i]   = smallest d attaining the max (nearest-match tie-break)
  full[i]  = exact (uncapped) run length at (i, off[i])

runlen(i, d), the number of consecutive equalities x[i+k] == x[i+k-d],
is (first mismatch position >= i in column d) - i: a reverse cumulative
min of the mismatch positions along the position axis. The offsets go in
chunks of ``chunk``; each chunk's plane is laid out (B, dc, N), so that
its reverse cummin is ``pext.rcummin_rows`` over (B * dc, N) rows: K7
(``csrc/rowscan.cu``) on a CUDA tensor, its plain version on a CPU
tensor. The byte compares, the key packing and the argmax are torch on
either device (JAX computes this plane outside any Pallas kernel).

Each (position, offset) gets the key ``score * 2048 + 2048 - d``, unique
per d, and the fold over chunks keeps a strictly greater key, so the
result does not depend on ``chunk``. It keeps JAX's values where no
offset matches: ``off`` is 1 and ``full`` is the run at d = 1 (the sort
backend gives 0 there), and a score can be 1; past ``n`` the score is
negative or -1, exactly as in JAX.
"""

from __future__ import annotations

import torch

from .. import spec
from . import pext

_BIG = 0x3FFFFFFF
_KEY = 2048          # key = score * _KEY + _KEY - d (d <= 2047)
#: offsets a fold step takes by default: 8 planes of 32768 x 256 int32
#: at the stream's widest pool, where JAX's min(4096, pool) makes one of
#: 512 MiB (the result does not depend on it)
FOLD = 256


def _chunk_scores(x: torch.Tensor, xp: torch.Tensor, nq: torch.Tensor,
                  d0: int, dc: int, window: int, cap: int):
    """Best (key, full run length) per position over offsets
    [d0 + 1, d0 + dc]: x int32[B, N]; xp the rows padded on the left by
    ``xp.shape[1] - N`` entries; nq int32[B, 1]. Returns int32[B, N]
    each."""
    b, npos = x.shape
    dev = x.device
    lead = xp.shape[1] - npos
    i = torch.arange(npos, dtype=torch.int32, device=dev)
    d = d0 + 1 + torch.arange(dc, dtype=torch.int32, device=dev)
    # hist[b, j, i] = xp[b, lead + i - d_j]: the window of xp that starts
    # lead - d_j, for d_j = d0 + 1 .. d0 + dc (descending starts, flipped)
    wins = xp.unfold(1, npos, 1)[:, lead - d0 - dc:lead - d0].flip(1)
    valid = ((wins == x[:, None, :]) & (i >= d[:, None])[None]
             & (i < nq)[:, None, :] & (d <= window)[None, :, None])
    # K7 takes contiguous rows; the plane may come out in the strides of
    # the flipped window view
    mm_pos = torch.where(valid, _BIG, i).contiguous()
    nm = pext.rcummin_rows(mm_pos.reshape(b * dc, npos)).reshape(b, dc, npos)
    # clamp to the block end: a run matching through the last row would
    # otherwise read as unbounded
    runlen = torch.minimum(nm - i, nq[:, :, None] - i)
    key = runlen.clamp(max=cap) * _KEY + (_KEY - d)[None, :, None]
    best_key, col = key.max(dim=1)
    best_full = runlen.gather(1, col[:, None, :])[:, 0]
    return best_key, best_full


def best_matches_batch(x: torch.Tensor, n: torch.Tensor, *,
                       window: int = spec.WINDOW_SIZE,
                       cap: int = spec.SEARCH_MATCH_MAX,
                       chunk: int = FOLD):
    """Per-position best-match table for a batch of blocks.

    x: int32[B, N] byte values (padding beyond ``n`` ignored); n: int32[B].
    ``chunk`` offsets go through each fold step (peak memory
    O(B * N * chunk)). Returns (score, off, full): int32[B, N] each, as
    ``jax.vmap(lzs_tpu.ops.match.best_matches)``.
    """
    if not 1 <= window <= spec.WINDOW_SIZE:
        raise ValueError(f"window {window} outside [1, {spec.WINDOW_SIZE}]")
    if chunk < 1:
        raise ValueError(f"chunk {chunk} < 1")
    x = x.to(torch.int32)
    b, npos = x.shape
    nq = n.to(torch.int32).reshape(b, 1)
    nchunks = -(-window // chunk)
    lead = nchunks * chunk
    xp = torch.cat([x.new_full((b, lead), -1), x], dim=1)
    best_key = torch.full_like(x, -1)
    best_full = torch.zeros_like(x)
    for c in range(nchunks):
        key, full = _chunk_scores(x, xp, nq, c * chunk, chunk, window, cap)
        upd = key > best_key
        best_key = torch.where(upd, key, best_key)
        best_full = torch.where(upd, full, best_full)
    score = torch.div(best_key, _KEY, rounding_mode="floor")
    off = _KEY - (best_key - score * _KEY)
    return score, off, best_full


def best_matches(x: torch.Tensor, n: torch.Tensor, *,
                 window: int = spec.WINDOW_SIZE,
                 cap: int = spec.SEARCH_MATCH_MAX, chunk: int = FOLD):
    """Per-position best-match table for one block.

    x: int32[N] byte values (padding beyond ``n`` ignored); n: int32
    scalar tensor, the true length. Returns (score, off, full): int32[N]
    each; ``score`` is the capped selection score (a match iff >=
    MIN_MATCH), ``off`` the chosen offset, ``full`` its exact run length.
    """
    s, o, f = best_matches_batch(x[None], n.reshape(1), window=window,
                                 cap=cap, chunk=chunk)
    return s[0], o[0], f[0]
