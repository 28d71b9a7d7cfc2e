"""lzs_tpu_torch: the match search's per-k glue (pcand) against JAX.

Seeded blocks of the kinds in tests/test_sortmatch_batch.py (tiny
alphabet, period 16, random, RLE), with block lengths npos, npos - 29 and
5, go through the JAX package's Pallas pcand kernels in interpret mode and
through the port's pcand on CPU tensors (the plain versions of K1 and
K2+K3 around torch.sort). For one level at a time both sides read the same
rank inputs, made by JAX's gram sort and ``_rank_lcp_rows``. Everything is
int32: tolerance 0.
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


def test_perk_keys_plain_matches_numpy_formula(ranks):
    plcp, p, _ = ranks
    r = np.arange(plcp.shape[1])
    for k in (2, 7, CAP):
        seg = np.maximum.accumulate(np.where(plcp < k, r, 0), axis=1)
        got = pcand.perk_keys_plain(_t(plcp), _t(p), k)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), (seg << 15) | p)
        assert torch.equal(pcand.perk_keys(_t(plcp), _t(p), k), got)


def test_perk_back_acc_is_out_of_place(ranks):
    plcp, p, n = ranks
    skey = torch.sort(pcand.perk_keys(_t(plcp), _t(p), 3), dim=1).values
    pk = torch.full(plcp.shape, -1, dtype=torch.int32)
    pk[:, ::3] = (2 << 16) | (32768 - 7)
    before = pk.clone()
    for fn in (pcand.perk_back_acc, pcand.perk_back_acc_plain):
        out = fn(skey, _t(n), pk, 3, 2047)
        assert torch.equal(pk, before)
        assert out.data_ptr() != pk.data_ptr()
        assert (out >= pk).all() and ((out >> 16) == 3).any()


def test_rows_wider_than_15_bit_positions_are_refused():
    z = torch.zeros((1, (1 << 15) + 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="at most 32768"):
        pcand.perk_keys(z, z, 2)
    with pytest.raises(ValueError, match="at most 32768"):
        pcand.perk_back_acc(z, torch.zeros(1, dtype=torch.int32), z, 2, 64)
