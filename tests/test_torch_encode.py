"""lzs_tpu_torch: match search, token walk and emission units vs JAX.

The same seeded blocks (small alphabets for steal-heavy runs, RLE,
long periodic runs to the data end, random bytes) go through the JAX
package's off-TPU path (vmapped ``candidates`` and ``_extend``, the XLA
token walk, ``emission_units_batch`` with its pext kernels in interpret
mode) and the port's batched torch stages on CPU tensors; every output
must be equal (tolerance 0). The port's search is also held to the form
JAX runs on its accelerator (``candidates_batch(pallas_glue=True)`` and
``_extend_batch``, Pallas in interpret mode). The encoded bytes are also
held to the NumPy reference model.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lzs_tpu import reference
from lzs_tpu.ops import sortmatch as jsm
from lzs_tpu.ops import tokenize as jtok
from lzs_tpu_torch.ops import encode, sortmatch, tokenize

from test_torch_cases import probe_lanes, probe_span_direct
from test_torch_pcand import mixed_blocks

NPOS = 2048


@pytest.fixture(scope="module")
def blocks():
    rng = np.random.default_rng(23)
    pat = rng.integers(0, 256, 300)
    rows = [
        rng.integers(97, 101, NPOS),                       # steal-heavy
        np.repeat(rng.integers(0, 256, NPOS // 32), 32),   # RLE runs
        np.concatenate([rng.integers(0, 256, 100),
                        np.tile(pat, 7)])[:NPOS],          # long far runs
        rng.integers(0, 256, NPOS),                        # incompressible
    ]
    x = np.stack(rows).astype(np.int32)
    n = np.array([NPOS, NPOS - 13, NPOS - 5, 901], np.int32)
    for i in range(len(n)):
        x[i, n[i]:] = 0
    return x, n


def _t(a):
    return torch.from_numpy(np.array(a))


def test_candidates_batch_matches_jax(blocks):
    x, n = blocks
    want = jax.jit(jsm.candidates_batch)(jnp.asarray(x), jnp.asarray(n))
    got = sortmatch.candidates_batch(_t(x), _t(n))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_best_matches_batch_matches_jax(blocks):
    x, n = blocks
    want = jsm.best_matches_batch(jnp.asarray(x), jnp.asarray(n))
    got = sortmatch.best_matches_batch(_t(x), _t(n))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # the probe tier ran, including runs past its first compare span
    full = got[2].numpy()
    assert full.max() > 64 + 12


def test_best_matches_batch_matches_jax_accelerator_form():
    x, n = mixed_blocks(87, 3, 4096)
    xj, nj = jnp.asarray(x), jnp.asarray(n)
    score, off = jax.jit(lambda a, m: jsm.candidates_batch(
        a, m, pallas_glue=True))(xj, nj)
    full = jax.jit(lambda: jsm._extend_batch(xj, nj, score, off, 12))()
    got = sortmatch.best_matches_batch(_t(x), _t(n))
    for g, w in zip(got, (score, off, full), strict=True):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[2].numpy().max() > 64 + 12


def _direct_runs(x, n, doff, active, cap):
    """Run length at a = i + cap for every active position, byte by byte."""
    want = np.zeros(x.shape, np.int64)
    for b, i in zip(*np.nonzero(active)):
        a, d, run = i + cap, max(int(doff[b, i]), 1), 0
        while a + run < n[b] and x[b, a + run] == x[b, a + run - d]:
            run += 1
        want[b, i] = run
    return want


def test_probe_matches_direct_runs():
    rng = np.random.default_rng(4)
    x = rng.integers(0, 3, (3, 500)).astype(np.int32)
    x[1, 100:400] = 7
    n = np.array([500, 450, 300], np.int32)
    active = rng.random((3, 500)) < 0.2
    doff = rng.integers(1, 12, (3, 500)).astype(np.int32)
    got = sortmatch._probe_batch(_t(x), _t(n), _t(doff), _t(active), 12)
    np.testing.assert_array_equal(got.numpy(),
                                  _direct_runs(x, n, doff, active, 12))
    assert got.numpy().max() > 4 * 12                 # tier 2 ran


def test_probe_waves_match_direct_runs():
    """More active positions in a row than one wave's lanes: the rows
    take three waves, each delivered by probe rank."""
    rng = np.random.default_rng(6)
    npos = 2600
    x = rng.integers(0, 2, (2, npos)).astype(np.int32)
    x[0, 1000:1900] = 5
    n = np.array([npos, npos - 77], np.int32)
    active = rng.random((2, npos)) < 0.9
    # an offset reaches back at most to the block start, as off <= i does
    doff = np.minimum(rng.integers(1, 300, (2, npos)),
                      np.arange(npos) + 1).astype(np.int32)
    assert active.sum(1).max() > 2 * 1024
    got = sortmatch._probe_batch(_t(x), _t(n), _t(doff), _t(active), 12)
    np.testing.assert_array_equal(got.numpy(),
                                  _direct_runs(x, n, doff, active, 12))


def test_probe_far_offsets_match_direct_runs():
    """Offsets past 2047 (the generalized coders' windows, up to 4095 and
    the block's reach): each lane compares at its own offset."""
    rng = np.random.default_rng(8)
    npos = 8192
    period = rng.integers(0, 256, 3000)
    x = np.stack([np.tile(period, 3)[:npos],
                  rng.integers(0, 2, npos)]).astype(np.int32)
    n = np.array([npos, npos - 5], np.int32)
    active = rng.random((2, npos)) < 0.3
    doff = np.minimum(rng.choice([2047, 2048, 3000, 4095, 8000], (2, npos)),
                      np.arange(npos) + 1).astype(np.int32)
    got = sortmatch._probe_batch(_t(x), _t(n), _t(doff), _t(active), 12)
    want = _direct_runs(x, n, doff, active, 12)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[0][doff[0] == 3000].max() > 4 * 12    # tier 2 ran


@pytest.mark.parametrize("b,npos,p,cap", [
    (12, 2100, 256, 12), (6, 300, 300, 12), (6, 32768, 64, 12),
    (7, 1500, 128, 16), (6, 1500, 64, 2), (1, 3547, 1024, 12)])
def test_probe_span_plain_matches_direct_loop(b, npos, p, cap):
    """Tier 1 of the probe (``probe_span``'s plain form, which the CPU
    path runs) against a byte-by-byte loop on the seeded wave lanes: empty
    and all-live rows, runs of 47 to 49 bytes, a run that reaches n inside
    the span, a clamped at N - 1, offsets 2047, 2048, 4095 and 32767."""
    x, n, srt = probe_lanes(npos + cap, b, npos, p, cap)
    got = sortmatch.probe_span_plain(_t(x), _t(n), _t(srt), cap)
    for g, w in zip(got, probe_span_direct(x, n, srt, cap), strict=True):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("b", [3, 8])
def test_probe_matches_jax_probe_batch(b):
    """The port's wave-form probe against JAX's (gather_big, rank_mask
    and rcummin_rows in interpret mode) on the need_probe heads of the
    mixed blocks."""
    x, n = mixed_blocks(41 + b, b, 512)
    xj, nj = jnp.asarray(x), jnp.asarray(n)
    score, off = jax.jit(jax.vmap(lambda a, m: jsm.candidates(a, m)))(xj, nj)
    from lzs_tpu.ops import pext as jpext
    need = (np.asarray(jpext.ext_breaks(score, off, nj, 12)) & 1) != 0
    assert need.any()
    want = jax.jit(lambda: jsm._probe_batch(xj, nj, off, jnp.asarray(need),
                                            12))()
    got = sortmatch._probe_batch(_t(x), _t(n), _t(off), _t(need), 12)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_emission_units_and_walk_match_jax(blocks):
    x, n = blocks
    xj, nj = jnp.asarray(x), jnp.asarray(n)
    score, off, full = jsm.best_matches_batch(xj, nj)
    want = jax.jit(jtok.emission_units_batch)(xj, nj, score, off, full)
    got = tokenize.emission_units_batch(_t(x), _t(n), _t(score), _t(off),
                                        _t(full))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    step = np.where(np.arange(NPOS) < n[:, None], np.asarray(want[3]), 1)
    walk = jax.jit(jax.vmap(jtok._token_starts_xla))(
        jnp.asarray(step.astype(np.int32)), nj)
    np.testing.assert_array_equal(
        tokenize.token_starts(_t(step.astype(np.int32)), _t(n)).numpy(),
        np.asarray(walk))


def test_token_walk_odd_width_matches_jax():
    rng = np.random.default_rng(9)
    step = rng.integers(1, 300, (2, 1000)).astype(np.int32)
    n = np.array([1000, 517], np.int32)
    want = jax.jit(jax.vmap(jtok._token_starts_xla))(jnp.asarray(step),
                                                     jnp.asarray(n))
    got = tokenize.token_starts(_t(step), _t(n))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_token_walk_past_65535_positions():
    """Positions stay int32: a walk past 2**16 positions marks exactly
    the chain a host walk visits."""
    rng = np.random.default_rng(10)
    npos = 70_000
    step = rng.integers(1, 40, (1, npos)).astype(np.int32)
    want = np.zeros(npos, bool)
    i = 0
    while i < npos:
        want[i] = True
        i += int(step[0, i])
    got = tokenize.token_starts(_t(step), _t(np.array([npos], np.int32)))
    np.testing.assert_array_equal(got[0].numpy(), want)


@pytest.mark.parametrize("policy", ["greedy", "lazy"])
def test_encode_batch_matches_reference(blocks, policy):
    x, n = blocks
    comp, nbytes = encode.encode_batch(_t(x), _t(n), policy=policy)
    for i in range(len(n)):
        data = x[i, :n[i]].astype(np.uint8).tobytes()
        got = comp[i, :int(nbytes[i])].numpy().tobytes()
        if policy == "greedy":
            assert got == reference.lzs_compress(data)
        else:
            assert reference.lzs_decompress(got) == data
