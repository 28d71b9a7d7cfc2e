"""lzs_tpu_torch: sync-parallel container decode (decode2) against JAX.

JAX-encoded blocks with their sync records go through
``lzs_tpu.ops.decode2`` (vmapped lane parse, record fill and the pexpand
Pallas kernel in interpret mode) and the port's decode2 on CPU tensors:
lane tiles, parse records, lane end positions, filled records, bytes and
status words must be equal (tolerance 0), for clean streams and for a
corrupted sync record (status bit 2).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lzs_tpu.ops import decode2 as jdec2
from lzs_tpu.ops import encode as jenc
from lzs_tpu_torch.ops import decode2

NPOS = 2048


def _batch():
    rng = np.random.default_rng(31)
    pat = rng.integers(0, 256, 45)
    rows = [
        np.tile(pat, 50)[:NPOS],
        np.repeat(rng.integers(0, 256, 40), 60)[:1900],
        rng.integers(0, 256, 333),
        np.frombuffer(b"Z" * 1500 + b"the quick brown fox " * 20, np.uint8),
    ]
    x = np.zeros((len(rows), NPOS), np.uint8)
    n = np.zeros(len(rows), np.int32)
    for i, r in enumerate(rows):
        x[i, :len(r)] = r
        n[i] = len(r)
    return x, n


@pytest.fixture(scope="module", params=[160, 2048])
def encoded(request):
    span = request.param
    x, n = _batch()
    comp, _, sbit, sout, _ = jenc.encode_batch_sync(
        jnp.asarray(x), jnp.asarray(n), span=span)
    return (x, n, np.array(comp), np.array(sbit), np.array(sout), span)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_lane_tiles_and_parse_match_jax(encoded):
    x, n, comp, sbit, sout, span = encoded
    nslots = sbit.shape[1]
    want_tile = jax.vmap(lambda c: jdec2._lane_tiles(c, nslots, span))(
        jnp.asarray(comp))
    got_tile = decode2._lane_tiles(_t(comp), nslots, span)
    np.testing.assert_array_equal(
        got_tile.numpy(), np.asarray(want_tile).astype(np.uint32))

    want_recs, want_final = jax.jit(jax.vmap(
        lambda c, b, o: jdec2._parse_full(c, b, o, span)))(
        jnp.asarray(comp).astype(jnp.int32), jnp.asarray(sbit),
        jnp.asarray(sout))
    got_recs, got_final = decode2._parse_full(_t(comp), _t(sbit), _t(sout),
                                              span)
    np.testing.assert_array_equal(got_recs.numpy(), np.asarray(want_recs))
    np.testing.assert_array_equal(got_final.numpy(), np.asarray(want_final))

    want_fill = jdec2._filled_records(want_recs)
    np.testing.assert_array_equal(
        decode2._filled_records(got_recs).numpy(), np.asarray(want_fill))


def test_decode_batch_sync_matches_jax(encoded):
    x, n, comp, sbit, sout, span = encoded
    want_out, want_st = jdec2.decode_batch_sync(
        jnp.asarray(comp), jnp.asarray(sbit), jnp.asarray(sout),
        jnp.asarray(n), out_cap=NPOS, span=span)
    got_out, got_st = decode2.decode_batch_sync(
        _t(comp), _t(sbit), _t(sout), _t(n), out_cap=NPOS, span=span)
    np.testing.assert_array_equal(got_out.numpy(), np.asarray(want_out))
    np.testing.assert_array_equal(got_st.numpy(), np.asarray(want_st))
    assert not got_st.any()
    for i in range(len(n)):
        np.testing.assert_array_equal(got_out[i, :n[i]].numpy(),
                                      x[i, :n[i]])


def test_corrupt_sync_record_sets_status_bit_2(encoded):
    x, n, comp, sbit, sout, span = encoded
    sout = sout.copy()
    sout[0, 1] += 3                   # lane 1 starts at a wrong output byte
    want_out, want_st = jdec2.decode_batch_sync(
        jnp.asarray(comp), jnp.asarray(sbit), jnp.asarray(sout),
        jnp.asarray(n), out_cap=NPOS, span=span)
    got_out, got_st = decode2.decode_batch_sync(
        _t(comp), _t(sbit), _t(sout), _t(n), out_cap=NPOS, span=span)
    np.testing.assert_array_equal(got_st.numpy(), np.asarray(want_st))
    assert got_st[0] & 4 and not got_st[1:].any()
    np.testing.assert_array_equal(got_out.numpy()[1:],
                                  np.asarray(want_out)[1:])
