"""lzs_tpu_torch: the token walk (pwalk) against the JAX package.

``lzs_tpu.ops.pwalk.walk_starts`` (its three Pallas kernels in interpret
mode) and the port's ``walk_starts`` (the plain version of each stage on
CPU tensors) get the same int32 steps, made from a seed, and must give
the same token-start flags (tolerance 0), on the cases of
tests/test_pwalk.py; the port alone is also held to a host walk of the
chain past 2^16 positions and at widths that are not a multiple of 128.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lzs_tpu.ops import pwalk as jpwalk
from lzs_tpu_torch.ops import pwalk, tokenize

from test_torch_cases import WALK_SKIPS, walk_entries_numpy, walk_steps


def host_walk(step, n):
    starts = np.zeros(step.shape[0], bool)
    i = 0
    while i < n:
        starts[i] = True
        i += max(int(step[i]), 1)
    return starts


def _long_jumps(seed, b, npos):
    rng = np.random.default_rng(seed)
    step = rng.integers(1, 9, (b, npos)).astype(np.int32)
    for _ in range(npos // 16):
        bb, ii = rng.integers(0, b), rng.integers(0, npos)
        step[bb, ii] = rng.integers(1, npos // 2)
    return step


def _walk(step, n):
    return pwalk.walk_starts(torch.from_numpy(step),
                             torch.from_numpy(n)).numpy()


@pytest.mark.parametrize("seed,npos", [(0, 256), (1, 1024), (2, 2048)])
def test_walk_matches_jax_pwalk(seed, npos):
    step = _long_jumps(seed, 4, npos)
    n = np.array([npos, npos - 7, npos // 2 + 1, 1], np.int32)
    want = np.asarray(jpwalk.walk_starts(jnp.asarray(step), jnp.asarray(n)))
    got = _walk(step, n)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, np.stack([host_walk(step[i], n[i]) for i in range(4)]))


def test_walk_odd_tile_count_and_empty_row_match_jax():
    rng = np.random.default_rng(3)
    b, npos = 3, 1536
    step = rng.integers(1, 20, (b, npos)).astype(np.int32)
    n = np.array([npos, 1000, 0], np.int32)
    want = np.asarray(jpwalk.walk_starts(jnp.asarray(step), jnp.asarray(n)))
    got = _walk(step, n)
    np.testing.assert_array_equal(got, want)
    assert not got[2].any()


def test_walk_past_2_16_positions_matches_host_walk():
    rng = np.random.default_rng(3)
    npos = 128 * 1024
    step = rng.integers(1, 30, (2, npos)).astype(np.int32)
    n = np.array([npos, npos - 777], np.int32)
    got = _walk(step, n)
    for b in range(2):
        np.testing.assert_array_equal(got[b], host_walk(step[b], n[b]))


@pytest.mark.parametrize("npos", [1, 127, 129, 1000])
def test_walk_ragged_width(npos):
    step = _long_jumps(npos, 3, max(npos, 32))[:, :npos]
    step[1] = 1
    n = np.array([npos, npos, npos // 2], np.int32)
    got = _walk(np.ascontiguousarray(step), n)
    assert got.shape == (3, npos)
    np.testing.assert_array_equal(
        got, np.stack([host_walk(step[i], n[i]) for i in range(3)]))
    assert got[1].all()


@pytest.mark.parametrize("b,ntiles", [(3, 1), (33, 256), (4, 600),
                                      (1, 6272)])
def test_walk_entries_match_numpy_recurrence(b, ntiles):
    """The seeded rows of the card's tests: chains that skip a ring slot's
    and a ring's worth of tiles (odd rows) and leave the row (row 0)."""
    step = torch.from_numpy(walk_steps(ntiles, b, ntiles))
    _, exits = pwalk.walk_tables(step)
    got = pwalk.walk_entries(exits)
    want = walk_entries_numpy(exits.numpy())
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0, -1] >= 1 << 30 or ntiles == 1
    if ntiles >= 500 and b > 1:
        jumps = np.diff(want[1]) // 128
        assert jumps.max() >= max(WALK_SKIPS)


def test_stages_chained_equal_walk_starts():
    step = torch.from_numpy(_long_jumps(9, 5, 1024))
    step[2, 0] = 0                      # a step < 1 counts as 1
    n = torch.tensor([1024, 1000, 500, 1, 0], dtype=torch.int32)
    tabs, exits = pwalk.walk_tables(step)
    assert tabs.shape == (7, 5, 8, 128) and tabs.dtype == torch.int32
    assert exits.shape == (5, 8, 128)
    entries = pwalk.walk_entries(exits)
    assert entries.shape == (5, 8) and entries.dtype == torch.int32
    got = pwalk.walk_descent(tabs, entries, n, 1024)
    assert torch.equal(got, pwalk.walk_starts(step, n))
    assert torch.equal(got, tokenize.token_starts(step, n))
    # level 0 is one hop, and entries start every row at 0
    i = torch.arange(1024, dtype=torch.int32)
    assert torch.equal(tabs[0].reshape(5, 1024), i + step.clamp(min=1))
    assert not entries[:, 0].any()
