"""lzs_tpu_torch: row scans (pext), the jax-free import and the spec.

The port's scans on CPU tensors (their plain versions) against the JAX
package's Pallas roll-scan kernels in interpret mode, on the same int32
inputs made from a seed; exact equality (integers, tolerance 0).
"""

import dataclasses
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lzs_tpu import spec as jspec
from lzs_tpu.ops import pext as jpext
from lzs_tpu_torch import spec as tspec
from lzs_tpu_torch.ops import pext

REPO = pathlib.Path(__file__).resolve().parent.parent


def _rows(seed: int, b: int, w: int) -> np.ndarray:
    """int32 rows with negative values and the -1 / 0x3FFFFFFF sentinels."""
    rng = np.random.default_rng(seed)
    v = rng.integers(-(1 << 20), 1 << 20, (b, w), dtype=np.int64)
    pick = rng.random((b, w))
    v[pick < 0.15] = -1
    v[pick > 0.85] = 0x3FFFFFFF
    return v.astype(np.int32)


@pytest.mark.parametrize("b,w", [(8, 1024), (32, 128), (3, 777), (1, 1)])
def test_scans_match_jax_pext(b, w):
    v = _rows(b * 1000 + w, b, w)
    got_max = pext.cummax_rows(torch.from_numpy(v)).numpy()
    got_min = pext.rcummin_rows(torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(
        got_max, np.asarray(jpext.cummax_rows(jnp.asarray(v))))
    np.testing.assert_array_equal(
        got_min, np.asarray(jpext.rcummin_rows(jnp.asarray(v))))


@pytest.mark.parametrize("w,tile", [(1000, 8192), (4096, 1024)])
def test_cumsum_rows_wide_matches_jax_pext(w, tile):
    # batch 32 (F4); the 0x3FFFFFFF entries make the sums wrap like int32
    v = _rows(w + tile, 32, w)
    got = pext.cumsum_rows_wide(torch.from_numpy(v), tile=tile)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jpext.cumsum_rows_wide(jnp.asarray(v),
                                                      tile=tile)))


def test_scan_plain_versions_are_the_cpu_path():
    v = torch.from_numpy(_rows(5, 4, 300))
    assert torch.equal(pext.cummax_rows(v), pext.cummax_rows_plain(v))
    assert torch.equal(pext.rcummin_rows(v), pext.rcummin_rows_plain(v))
    assert torch.equal(pext.cumsum_rows_wide(v), pext.cumsum_rows_plain(v))


def test_scan_rejects_unsupported_device():
    v = torch.zeros((2, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        pext.cummax_rows(v)


def test_port_imports_no_jax():
    code = ("import sys, lzs_tpu_torch, lzs_tpu_torch.blocks, "
            "lzs_tpu_torch.convert\n"
            "import lzs_tpu_torch.ops.encode, lzs_tpu_torch.ops.decode2\n"
            "import lzs_tpu_torch.ops.decode, lzs_tpu_torch.ops.bitpar, "
            "lzs_tpu_torch.ops.pwalk\n"
            "assert 'jax' not in sys.modules, sorted(sys.modules)\n"
            "assert 'lzs_tpu' not in sys.modules\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=REPO)
    assert res.returncode == 0, res.stderr


def test_spec_constants_equal_jax_package():
    public = [k for k in dir(jspec) if k.isupper() and k != "DEFAULT_CONFIG"]
    assert len(public) > 10
    for k in public:
        assert getattr(tspec, k) == getattr(jspec, k), k
    assert (dataclasses.asdict(tspec.DEFAULT_CONFIG)
            == dataclasses.asdict(jspec.DEFAULT_CONFIG))
    for n in (0, 1, 7, 8, 2048, 32768):
        assert tspec.compressed_max(n) == jspec.compressed_max(n)
        assert tspec.decompressed_max(n) == jspec.decompressed_max(n)
    for off in (1, 127, 128, 2047):
        for length in (2, 7, 8, 22, 23, 300):
            assert tspec.match_bits(off, length) == jspec.match_bits(
                off, length)
