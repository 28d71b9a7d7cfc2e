"""lzs_tpu_torch: the wide-table gather (K10, pgather.gather_big) vs JAX.

The port's gather on CPU tensors (its plain version) against the JAX
package's Pallas kernel in interpret mode, on the same seeded int32
tables and indices (out of range on both sides, so the clamp is tested);
exact equality. JAX's kernel takes W and Q in multiples of 128; the
port's takes any, held to numpy there.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lzs_tpu.ops import pgather as jpgather
from lzs_tpu_torch.ops import pgather


def _inputs(seed, b, w, q):
    rng = np.random.default_rng(seed)
    tab = rng.integers(-(1 << 31), 1 << 31, (b, w), dtype=np.int64)
    idx = rng.integers(-5, w + 5, (b, q))
    return tab.astype(np.int32), idx.astype(np.int32)


@pytest.mark.parametrize("b,w,q", [(8, 640, 1024), (3, 128, 256),
                                   (32, 256, 128)])
def test_gather_big_matches_jax(b, w, q):
    tab, idx = _inputs(b * w + q, b, w, q)
    got = pgather.gather_big(torch.from_numpy(tab), torch.from_numpy(idx))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(),
        np.asarray(jpgather.gather_big(jnp.asarray(tab), jnp.asarray(idx))))


@pytest.mark.parametrize("b,w,q", [(2, 1, 7), (5, 1000, 333), (1, 77, 0)])
def test_gather_big_any_width(b, w, q):
    tab, idx = _inputs(w + q, b, w, q)
    got = pgather.gather_big(torch.from_numpy(tab), torch.from_numpy(idx))
    want = np.take_along_axis(tab, np.clip(idx, 0, w - 1), axis=1)
    np.testing.assert_array_equal(got.numpy(), want)


def test_gather_big_rejects_bad_shapes():
    tab = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        pgather.gather_big(tab, torch.zeros((3, 4), dtype=torch.int32))
    with pytest.raises(ValueError):
        pgather.gather_big(tab[:, :0], torch.zeros((2, 4), dtype=torch.int32))
    with pytest.raises(ValueError):
        pgather.gather_big(tab[0], torch.zeros(4, dtype=torch.int32))
