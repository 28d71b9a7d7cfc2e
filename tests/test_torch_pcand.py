"""lzs_tpu_torch: the match search's per-k glue (pcand) against JAX.

Seeded blocks of the kinds in tests/test_sortmatch_batch.py (tiny
alphabet, period 16, random, RLE), with block lengths npos, npos - 29 and
5, go through the JAX package's Pallas pcand kernels in interpret mode and
through the port's pcand on CPU tensors (``perk_level_plain``: the plain
versions of K1 and K2+K3 around torch.sort). For one level at a time both
sides read the same rank inputs, made by JAX's gram sort and
``_rank_lcp_rows``, also with their LCPs replaced to make one segment of
each row or only singletons. Everything is int32: tolerance 0.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lzs_tpu.ops import pcand as jpcand
from lzs_tpu.ops import sortmatch as jsm
from lzs_tpu_torch.ops import pcand, sortmatch

CAP = 12


def mixed_blocks(seed: int, b: int, npos: int):
    """int32 (B, npos) blocks cycling through the four kinds, zero past n;
    n cycles through npos, npos - 29 and 5."""
    rng = np.random.default_rng(seed)
    kinds = [
        lambda: rng.integers(0, 4, npos) + 97,                  # tiny alphabet
        lambda: np.tile(rng.integers(0, 256, 16), npos // 16 + 1)[:npos],
        lambda: rng.integers(0, 256, npos),                     # random
        lambda: np.repeat(rng.integers(0, 256, npos // 64 + 1),
                          64)[:npos],                           # RLE runs
    ]
    x = np.stack([kinds[r % 4]() for r in range(b)]).astype(np.int32)
    lens = (npos, npos - 29, 5)
    n = np.array([lens[r % 3] for r in range(b)], np.int32)
    for r in range(b):
        x[r, n[r]:] = 0
    return x, n


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_ranks(x: np.ndarray):
    """(plcp, p) as JAX's accelerator path makes them: the gram-word row
    sort with the position as payload, then ``_rank_lcp_rows``."""
    b, npos = x.shape
    nwords = -(-CAP // 4)
    words = jsm._gram_words(jnp.asarray(x), nwords)
    pos = jnp.broadcast_to(jnp.arange(npos, dtype=jnp.int32)[None], (b, npos))
    out = jpcand._row_sort(tuple(words) + (pos,), b, num_keys=nwords)
    plcp = jsm._rank_lcp_rows(list(out[:nwords]), CAP)
    return np.asarray(plcp), np.asarray(out[-1])


@pytest.fixture(scope="module")
def ranks():
    x, n = mixed_blocks(5, 4, 512)
    plcp, p = _jax_ranks(x)
    return plcp, p, n


@pytest.mark.parametrize("window", [2047, 64])
@pytest.mark.parametrize("k", range(2, CAP + 1))
def test_one_level_matches_jax(ranks, k, window):
    plcp, p, n = ranks
    want = jpcand.perk_candidates(jnp.asarray(plcp), jnp.asarray(p),
                                  jnp.asarray(n), kmin=k, kmax=k,
                                  window=window)
    got = pcand.perk_candidates(_t(plcp), _t(p), _t(n), kmin=k, kmax=k,
                                window=window)
    for g, w in zip(got, want, strict=True):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    score, off = (g.numpy() for g in got)
    assert (score == k).any() and not ((score != 0) & (score != k)).any()
    assert off.max() <= window


@pytest.mark.parametrize("b", [4, 8])
@pytest.mark.parametrize("npos", [512, 1024])
def test_candidates_batch_matches_jax_pallas_glue(npos, b):
    x, n = mixed_blocks(npos + b, b, npos)
    want = jax.jit(lambda a, m: jsm.candidates_batch(a, m, pallas_glue=True))(
        jnp.asarray(x), jnp.asarray(n))
    got = sortmatch.candidates_batch(_t(x), _t(n))
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("window", [2047, 64])
def test_candidates_batch_any_width_matches_jax_vmapped(window):
    """npos 1000 is no multiple of 512, which JAX's accelerator path
    needs; the port takes it."""
    x, n = mixed_blocks(1000 + window, 4, 1000)
    want = jax.jit(jax.vmap(lambda a, m: jsm.candidates(
        a, m, window=window)))(jnp.asarray(x), jnp.asarray(n))
    got = sortmatch.candidates_batch(_t(x), _t(n), window=window)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.fixture(scope="module")
def ranks_1000():
    x, n = mixed_blocks(7, 4, 1000)
    plcp, p = _jax_ranks(x)
    return plcp, p, n


def _segments(ranks, ranks_1000, shape):
    plcp, p, n = ranks_1000 if shape == "N 1000" else ranks
    if shape == "one segment":          # plcp >= k but at rank 0
        plcp = np.full_like(plcp, CAP)
        plcp[:, 0] = 0
    elif shape == "singletons":
        plcp = np.zeros_like(plcp)
    elif shape == "full blocks":        # no padding: n = N in every row
        n = np.full_like(n, plcp.shape[1])
    return plcp, p, n


@pytest.mark.parametrize("window", [2047, 64])
@pytest.mark.parametrize("k", [2, CAP])
@pytest.mark.parametrize("shape", ["one segment", "singletons", "padded",
                                   "full blocks", "N 1000"])
def test_perk_level_plain_matches_jax_level(ranks, ranks_1000, shape, k,
                                            window):
    """One level of perk_level_plain from no earlier match against JAX's
    perk_candidates at kmin = kmax = k; "padded" rows have n < N."""
    plcp, p, n = _segments(ranks, ranks_1000, shape)
    want = jpcand.perk_candidates(jnp.asarray(plcp), jnp.asarray(p),
                                  jnp.asarray(n), kmin=k, kmax=k,
                                  window=window)
    pk = pcand.perk_level_plain(_t(plcp), _t(p), _t(n),
                                torch.full(plcp.shape, -1, dtype=torch.int32),
                                k, window)
    assert pk.dtype == torch.int32
    hit = pk >= 0
    got = (torch.where(hit, pk >> 16, 0),
           torch.where(hit, 32768 - (pk & 0xFFFF), 0))
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if shape == "singletons":
        assert not hit.any()
    if shape == "one segment":
        assert hit.any()


def test_perk_keys_plain_matches_numpy_formula(ranks):
    plcp, p, n = ranks
    r = np.arange(plcp.shape[1])
    pk = torch.full(plcp.shape, -1, dtype=torch.int32)
    for k in (2, 7, CAP):
        seg = np.maximum.accumulate(np.where(plcp < k, r, 0), axis=1)
        keys = (seg << 15) | p
        got = pcand.perk_keys_plain(_t(plcp), _t(p), k)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), keys)
        # the level is the fold of the numpy keys, sorted
        assert torch.equal(
            pcand.perk_level(_t(plcp), _t(p), _t(n), pk, k, 2047),
            pcand.perk_back_acc_plain(_t(np.sort(keys, axis=1)), _t(n), pk,
                                      k, 2047))


def test_perk_back_acc_is_out_of_place(ranks):
    plcp, p, n = ranks
    pk = torch.full(plcp.shape, -1, dtype=torch.int32)
    pk[:, ::3] = (2 << 16) | (32768 - 7)
    before = pk.clone()
    for fn in (pcand.perk_level, pcand.perk_level_plain):
        out = fn(_t(plcp), _t(p), _t(n), pk, 3, 2047)
        assert torch.equal(pk, before)
        assert out.data_ptr() != pk.data_ptr()
        assert (out >= pk).all() and ((out >> 16) == 3).any()


def test_position_missing_from_p_keeps_pk(ranks):
    """A p that repeats one position and so lacks another: with no hit in
    the level (singletons), every position keeps pk, the missing one too."""
    plcp, p, n = ranks
    p = p.copy()
    p[:, 1] = p[:, 0]
    pk = torch.from_numpy(np.random.default_rng(3).integers(
        -1, 1 << 20, plcp.shape, dtype=np.int32))
    got = pcand.perk_level(_t(np.zeros_like(plcp)), _t(p), _t(n), pk, 2, 2047)
    assert torch.equal(got, pk)


def test_rows_wider_than_15_bit_positions_are_refused():
    z = torch.zeros((1, (1 << 15) + 1), dtype=torch.int32)
    n = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="at most 32768"):
        pcand.perk_level(z, z, n, z, 2, 64)
    with pytest.raises(ValueError, match="at most 32768"):
        pcand.perk_candidates(z, z, n, kmin=2, kmax=12, window=64)
