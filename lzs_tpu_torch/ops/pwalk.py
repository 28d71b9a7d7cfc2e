"""Greedy token-chain starts for a batch of rows, by pointer doubling.

Port of ``lzs_tpu.ops.pwalk``. Position 0 starts a token and a token at
i is followed by one at i + max(step[i], 1) (the reference walks this
chain one token at a time, lzs-compression.c:301-448). Rows are cut into
T tiles of 128 positions and the chain is resolved in three stages, each
a kernel on a CUDA tensor (``csrc/walk.cu``) and its plain torch version
on a CPU tensor:

  walk_tables   (K11, ``_tables_kernel``) in-tile jump tables: level t
                holds the position after 2^t hops, frozen once the chain
                leaves the tile; the tile exits after 7 levels.
  walk_entries  (K12, ``_entries_kernel``) the entry of tile t + 1 is the
                exit of the chain from tile t's entry, threaded tile by
                tile: the walk's one serial dependency.
  walk_descent  (K13, ``_descent_kernel``) each position descends the
                levels from its tile's entry; it is a token start iff the
                chain lands on it.

``walk_starts`` chains the three. Unlike the JAX form it takes any row
width (a ragged row is padded with steps of 1). Positions stay int32:
chains reach N + the largest step.

Callers: the encoder's token walk (tokenize) and the raw decoder's
per-bit head walk (bitpar).
"""

from __future__ import annotations

import torch

from . import _kernels

_TILE = 128
_ROUNDS = 7                     # log2(_TILE)


def _tile_bases(ntiles: int, device: torch.device) -> torch.Tensor:
    """int32[T, 1]: the first position of every tile."""
    return (torch.arange(ntiles, dtype=torch.int32, device=device)
            * _TILE)[:, None]


def walk_tables_plain(step: torch.Tensor):
    b, m = step.shape
    ntiles = m // _TILE
    base = _tile_bases(ntiles, step.device)
    i = torch.arange(m, dtype=torch.int32, device=step.device)
    a = (i + step.clamp(min=1)).reshape(b, ntiles, _TILE)
    levels = []
    for _ in range(_ROUNDS):
        levels.append(a)
        g = torch.gather(a, 2, (a - base).clamp(0, _TILE - 1).long())
        a = torch.where(a < base + _TILE, g, a)
    return torch.stack(levels), a


def walk_entries_plain(exits: torch.Tensor) -> torch.Tensor:
    b, ntiles, _ = exits.shape
    entries = torch.empty((b, ntiles), dtype=torch.int32, device=exits.device)
    c = torch.zeros((b, 1), dtype=torch.int32, device=exits.device)
    for t in range(ntiles):
        entries[:, t:t + 1] = c
        b0 = t * _TILE
        nxt = torch.gather(exits[:, t], 1, (c - b0).clamp(0, _TILE - 1).long())
        c = torch.where((c >= b0) & (c < b0 + _TILE), nxt, c)
    return entries


def walk_descent_plain(tabs: torch.Tensor, entries: torch.Tensor,
                       n: torch.Tensor, width: int) -> torch.Tensor:
    _, b, ntiles, _ = tabs.shape
    dev = tabs.device
    base = _tile_bases(ntiles, dev)
    i = torch.arange(ntiles * _TILE, dtype=torch.int32, device=dev)
    it = i.reshape(ntiles, _TILE)
    pos = entries[:, :, None].expand(b, ntiles, _TILE)
    for t in range(_ROUNDS - 1, -1, -1):
        nxt = torch.gather(tabs[t], 2, (pos - base).clamp(0, _TILE - 1).long())
        ok = (pos >= base) & (pos < base + _TILE) & (nxt <= it)
        pos = torch.where(ok, nxt, pos)
    starts = (pos == it).reshape(b, ntiles * _TILE)[:, :width]
    return starts & (i[:width] < n[:, None])


def walk_tables(step: torch.Tensor):
    """Jump tables of int32[B, M] steps, M % 128 == 0.

    Returns (tabs int32[7, B, T, 128], exits int32[B, T, 128]) with
    T = M / 128: tabs[t] is the position after 2^t hops (frozen past the
    tile), exits the first chain position past the tile.
    """
    if _kernels.on_cpu(step):
        return walk_tables_plain(step)
    _kernels.check(step, "step", torch.int32)
    b, m = step.shape
    if m % _TILE:
        raise ValueError(f"step: width {m} is not a multiple of {_TILE}")
    ntiles = m // _TILE
    tabs = torch.empty((_ROUNDS, b, ntiles, _TILE), dtype=torch.int32,
                       device=step.device)
    exits = torch.empty((b, ntiles, _TILE), dtype=torch.int32,
                        device=step.device)
    if b and ntiles:
        _kernels.WALK_TABLES.launch(step.device, step.data_ptr(),
                                    tabs.data_ptr(), exits.data_ptr(), b,
                                    ntiles)
    return tabs, exits


def walk_entries(exits: torch.Tensor) -> torch.Tensor:
    """int32[B, T]: the chain's entry position into every tile."""
    if _kernels.on_cpu(exits):
        return walk_entries_plain(exits)
    _kernels.check(exits, "exits", torch.int32)
    if exits.dim() != 3 or exits.shape[2] != _TILE:
        raise ValueError(f"exits: expected (B, T, {_TILE}), "
                         f"got {tuple(exits.shape)}")
    b, ntiles, _ = exits.shape
    entries = torch.empty((b, ntiles), dtype=torch.int32, device=exits.device)
    if b and ntiles:
        _kernels.WALK_ENTRIES.launch(exits.device, exits.data_ptr(),
                                     entries.data_ptr(), b, ntiles)
    return entries


def walk_descent(tabs: torch.Tensor, entries: torch.Tensor,
                 n: torch.Tensor, width: int) -> torch.Tensor:
    """bool[B, width]: token starts at positions < n[b] (width <= T*128)."""
    if _kernels.on_cpu(tabs, entries, n):
        return walk_descent_plain(tabs, entries, n, width)
    _kernels.check(tabs, "tabs", torch.int32)
    if tabs.dim() != 4 or tabs.shape[0] != _ROUNDS or tabs.shape[3] != _TILE:
        raise ValueError(f"tabs: expected ({_ROUNDS}, B, T, {_TILE}), "
                         f"got {tuple(tabs.shape)}")
    _, b, ntiles, _ = tabs.shape
    _kernels.check(entries, "entries", torch.int32, (b, ntiles))
    _kernels.check(n, "n", torch.int32, (b,))
    if not 0 <= width <= ntiles * _TILE:
        raise ValueError(f"width {width} outside [0, {ntiles * _TILE}]")
    starts = torch.empty((b, width), dtype=torch.bool, device=tabs.device)
    if b and width:
        _kernels.WALK_DESCENT.launch(tabs.device, tabs.data_ptr(),
                                     entries.data_ptr(), n.data_ptr(),
                                     starts.data_ptr(), b, ntiles, width)
    return starts


def walk_starts(step: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Token-start flags for a batch of rows.

    step: int[B, N] positions consumed by a token starting at each
    position (values < 1 count as 1), any N; n: int[B] true lengths
    (positions >= n are never starts). Returns bool[B, N].
    """
    b, npos = step.shape
    step = step.to(torch.int32)
    pad = (-npos) % _TILE
    if pad:
        step = torch.cat([step, step.new_ones((b, pad))], dim=1)
    tabs, exits = walk_tables(step.contiguous())
    entries = walk_entries(exits)
    del exits
    return walk_descent(tabs, entries, n.to(torch.int32).contiguous(), npos)
