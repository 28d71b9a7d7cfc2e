"""lzs_tpu_torch: the match search's ranks and per-k glue (pcand) against
JAX.

The ranks: the port's gram sort keys (``gram_keys``), its two stable row
sorts on them (``gram_sort``) and ``rank_lcp`` after them, on the CPU
their plain forms, give bitwise the gram words, the positions in (gram,
position) order and the rank LCPs of JAX's ``_gram_words``, the sort of
JAX's ``candidates`` and ``_rank_lcp_rows``: at every cap's key layout (no
key1 at cap <= 8, an int32 key1 up to 12, an int64 one past it), on rows
of one repeated byte (one long tie, its positions ascending), on bytes
either side of 0x80 at every key boundary (the sign flips), at widths 1,
1500, 3547 and 32768 and at batch 1; and ``candidates_batch`` on rows
with nonzero bytes past ``n`` (they enter the grams) gives what JAX's
vmapped ``candidates`` gives at each cap.

The glue: seeded blocks of the kinds in tests/test_sortmatch_batch.py
(tiny alphabet, period 16, random, RLE), with block lengths npos, npos -
29 and 5, go through the JAX package's Pallas pcand kernels in interpret
mode and through the port's pcand on CPU tensors (``perk_level_plain``:
the plain versions of K1 and K2+K3 around torch.sort). For one level at a
time both sides read the same rank inputs, made by JAX's gram sort and
``_rank_lcp_rows``, also with their LCPs replaced to make one segment of
each row or only singletons. Everything is integer: tolerance 0.
"""

import functools

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


@functools.partial(jax.jit, static_argnums=1)
def _jax_gram_ranks(x, cap: int):
    """JAX's gram words of x (B, N), its gram-word row sort with the
    position as the last key (the total order of ``candidates``), and
    ``_rank_lcp_rows``: (words, plcp, p). The words are taken of the rows
    with 16 zero bytes appended, since ``_shift`` wants a row at least a
    gram long, and cut back to N: the bytes past N read 0 all the same."""
    b, npos = x.shape
    nwords = -(-cap // 4)
    x = jnp.concatenate([x, jnp.zeros((b, 16), x.dtype)], axis=1)
    words = [w[:, :npos] for w in jsm._gram_words(x, nwords)]
    pos = jnp.broadcast_to(jnp.arange(npos, dtype=jnp.int32)[None], (b, npos))
    out = jpcand._row_sort(tuple(words) + (pos,), b, num_keys=nwords + 1)
    return words, jsm._rank_lcp_rows(list(out[:nwords]), cap), out[-1]


def _jax_ranks(x: np.ndarray, cap: int = CAP):
    """(plcp, p) as JAX makes them."""
    _, plcp, p = _jax_gram_ranks(jnp.asarray(x), cap)
    return np.asarray(plcp), np.asarray(p)


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


GRAM_CAPS = [2, 8, 9, 12, 13, 16]
GRAM_SHAPES = [(1, 1), (3, 1), (1, 1500), (4, 1500), (2, 3547), (1, 32768)]


def gram_rows(kind: str, seed: int, b: int, npos: int) -> np.ndarray:
    """int32 (b, npos) byte rows of one kind, no zeros past any n."""
    rng = np.random.default_rng(seed)
    if kind == "one byte":
        return np.full((b, npos), 0xAB, np.int32)
    if kind == "sign":
        # 0x00, 0x7F, 0x80 and 0xFF at every offset: every key boundary
        # sees a byte on each side of the sign bit
        return rng.choice([0x00, 0x7F, 0x80, 0xFF], (b, npos)).astype(
            np.int32)
    # text-like: a tiny alphabet with runs and random spans
    x = rng.integers(97, 101, (b, npos))
    x[rng.random((b, npos)) < 0.1] = rng.integers(0, 256)
    x[:, :: 97] = rng.integers(0, 256, x[:, :: 97].shape)
    return x.astype(np.int32)


def _key_words(key0: torch.Tensor, key1: torch.Tensor | None) -> list:
    """The 4-byte gram words that gram_keys' keys hold, int64 each."""
    flip = torch.iinfo(torch.int64).min
    k0 = key0 ^ flip
    words = [(k0 >> 32) & 0xFFFFFFFF, k0 & 0xFFFFFFFF]
    if key1 is not None and key1.dtype == torch.int32:
        words.append(key1.long() + (1 << 31))
    elif key1 is not None:
        k1 = key1 ^ flip
        words += [(k1 >> 32) & 0xFFFFFFFF, k1 & 0xFFFFFFFF]
    return words


@pytest.mark.parametrize("kind", ["text", "one byte", "sign"])
@pytest.mark.parametrize("b,npos", GRAM_SHAPES)
@pytest.mark.parametrize("cap", GRAM_CAPS)
def test_gram_ranks_match_jax(cap, b, npos, kind):
    """gram_keys' words, gram_sort's order and rank_lcp's plcp bitwise
    JAX's words, sort and _rank_lcp_rows."""
    x = gram_rows(kind, cap * npos + b, b, npos)
    words, want_plcp, want_p = _jax_gram_ranks(jnp.asarray(x), cap)
    xt = torch.from_numpy(x)
    key0, key1 = sortmatch.gram_keys(xt, cap)
    assert key0.dtype == torch.int64 and key0.shape == (b, npos)
    assert (key1 is None) == (cap <= 8)
    if key1 is not None:
        assert key1.dtype == (torch.int32 if cap <= 12 else torch.int64)
    got_words = _key_words(key0, key1)
    for w, got in enumerate(got_words):
        want = (np.asarray(words[w]).astype(np.int64) if w < len(words)
                else 0)         # key0's low word at cap <= 4
        np.testing.assert_array_equal(got.numpy(), np.broadcast_to(
            want, (b, npos)))
    plcp, p = sortmatch.rank_lcp(*sortmatch.gram_sort(xt, cap), cap)
    assert plcp.dtype == p.dtype == torch.int32
    np.testing.assert_array_equal(p.numpy(), np.asarray(want_p))
    np.testing.assert_array_equal(plcp.numpy(), np.asarray(want_plcp))
    if kind == "one byte":
        # the grams that hold no byte past N tie, last and in position
        # order; the shorter ones at the row's end come first
        full = max(npos - 4 * -(-cap // 4) + 1, 0)
        assert torch.equal(p[0, npos - full:],
                           torch.arange(full, dtype=torch.int32))


@pytest.mark.parametrize("cap", GRAM_CAPS)
def test_candidates_batch_reads_bytes_past_n(cap):
    """Rows whose bytes past n are not zero: they enter the grams, as
    they enter JAX's; the search gives what JAX's vmapped candidates
    gives."""
    rng = np.random.default_rng(cap)
    x = gram_rows("text", cap, 4, 1500)
    n = rng.integers(1, 1500, 4).astype(np.int32)
    want = jax.jit(jax.vmap(lambda a, m: jsm.candidates(a, m, cap=cap)))(
        jnp.asarray(x), jnp.asarray(n))
    got = sortmatch.candidates_batch(_t(x), _t(n), cap=cap)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("cap", [0, 1, 17])
def test_gram_keys_refuses_caps_outside_2_16(cap):
    x = torch.zeros((1, 4), dtype=torch.int32)
    for fn in (sortmatch.gram_keys, sortmatch.gram_keys_plain):
        with pytest.raises(ValueError, match="outside"):
            fn(x, cap)
