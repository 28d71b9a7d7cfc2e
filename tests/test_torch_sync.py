"""lzs_tpu_torch: decode-sync records (psync / encode) against JAX.

The JAX pipeline makes real emission units, bit offsets and token starts
from seeded data; ``lzs_tpu.ops.encode._sync_records_batch`` (its psync
Pallas kernel in interpret mode plus three sorts) and the port's
``_sync_records_batch`` (plain version on CPU tensors) get the same
arrays and must agree exactly. One row is all literals with an end-bit
offset that is a multiple of the span, where the last crossing record
falls on the sentinel slot. Generated unit rows at batch 33
(test_torch_cases.sync_batch: nibble chains across the sync kernel's
8192-position segments, offsets above 0xFFF, end_bits a multiple of the
span, empty and short rows) at 1 to 32768 positions are held to JAX the
same way.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lzs_tpu.ops import encode as jenc
from lzs_tpu_torch.ops import encode, psync

from test_torch_cases import sync_batch

NPOS = 1024


def _batch():
    rng = np.random.default_rng(17)
    rows = [
        np.frombuffer(bytes(range(64)), np.uint8),           # 576 bits
        np.tile(rng.integers(0, 256, 41, dtype=np.uint8), 30)[:NPOS],
        np.repeat(rng.integers(0, 4, NPOS // 16, dtype=np.uint8), 16),
        rng.integers(97, 101, 700).astype(np.uint8),
    ]
    x = np.zeros((len(rows), NPOS), np.uint8)
    n = np.zeros(len(rows), np.int32)
    for i, r in enumerate(rows):
        x[i, :len(r)] = r
        n[i] = len(r)
    return x, n


@pytest.fixture(scope="module")
def units():
    x, n = _batch()
    fn = jax.jit(lambda a, b: jenc._pipeline_batch(
        a, b, 2047, 12, 4096, "sort", "greedy"))
    comp, nbytes, total_bits, offs, width, starts, off = fn(
        jnp.asarray(x), jnp.asarray(n))
    arrays = dict(total_bits=total_bits, offs=offs, width=width,
                  starts=starts, off=off)
    return {k: np.array(v) for k, v in arrays.items()}, n


@pytest.mark.parametrize("span", [96, 288, 2048])
def test_sync_records_match_jax(units, span):
    a, n = units
    want = jax.jit(lambda tb, o, w, s, f, m: jenc._sync_records_batch(
        tb, o, w, s, f, m, span))(a["total_bits"], a["offs"], a["width"],
                                  a["starts"], a["off"], n)
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    got = encode._sync_records_batch(t["total_bits"], t["offs"], t["width"],
                                     t["starts"], t["off"],
                                     torch.from_numpy(n), span)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if span in (96, 288):
        end_bits = int(a["total_bits"][0]) - 9
        assert end_bits % span == 0       # the sentinel-slot case is live
        assert int(got[2][0]) == end_bits // span


def test_sync_records_plain_is_the_cpu_path(units):
    a, n = units
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    kw = dict(span=160, nibbles=6, short_len=8, ext_len=15,
              nslots=encode.sync_slots(NPOS, 160))
    args = (t["starts"], t["width"], t["off"], t["offs"],
            t["total_bits"] - 9, torch.from_numpy(n))
    for x, y in zip(psync.sync_records(*args, **kw),
                    psync.sync_records_plain(*args, **kw)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("policy", ["greedy", "lazy"])
def test_encode_batch_sync_matches_jax(policy):
    x, n = _batch()
    want = jenc.encode_batch_sync(jnp.asarray(x), jnp.asarray(n), span=288,
                                  policy=policy)
    got = encode.encode_batch_sync(torch.from_numpy(x), torch.from_numpy(n),
                                   span=288, policy=policy)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("npos,span", [(1, 128), (96, 96), (8193, 288),
                                       (32768, 2048)])
def test_sync_edge_rows_match_jax(npos, span):
    starts, width, off, offs, end_bits, n = sync_batch(npos, 33, npos, span)
    total = end_bits + 9
    want = jax.jit(lambda tb, o, w, s, f, m: jenc._sync_records_batch(
        tb, o, w, s, f, m, span))(total, offs, width, starts, off, n)
    got = encode._sync_records_batch(
        *(torch.from_numpy(a) for a in (total, offs, width, starts, off, n)),
        span)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if npos >= 96:      # row 2's crossing at end_bits falls on the sentinel
        assert int(got[2][2]) == end_bits[2] // span
        assert int(got[0][2, -1]) == end_bits[2]
