"""lzs_tpu_torch: bit packing (ppack / bitpack) against the JAX package.

Random well-formed units (value < 2**width) made from a seed go through
``lzs_tpu.ops.bitpack.pack_bits_batch`` (its ppack Pallas kernels in
interpret mode) and the port's ``pack_bits_batch`` on CPU tensors;
stream bytes, total bits and bit offsets must be equal (tolerance 0).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lzs_tpu import spec
from lzs_tpu.ops import bitpack as jbitpack
from lzs_tpu_torch.ops import bitpack, ppack

from test_torch_cases import pack_units

END = (spec.END_MARKER_VALUE, spec.END_MARKER_BITS)


def _units(seed: int, b: int, m: int, zero_rows=()):
    rng = np.random.default_rng(seed)
    widths = np.array([0, 0, 4, 9, 11, 13, 15, 17, 25])
    w = widths[rng.integers(0, len(widths), (b, m))].astype(np.int32)
    v = (rng.integers(0, 1 << 25, (b, m)) & ((1 << w) - 1)).astype(np.int32)
    for r in zero_rows:
        w[r] = 0
        v[r] = 0
    return v, w


def _cap(m: int) -> int:
    return (m * 25 // 8 + 16) & ~3


#: (b, m) -> share of live widths: tests/test_torch_cases.py's pack units
#: (zero-width stretches over the kernel's 4096- and 8192-unit segment
#: edges, a zero segment and a zero row, totals that end a word or put the
#: end marker across one), which the gpu tests feed to the kernel too, at
#: cap_bytes 65536 (the JAX packer's 2^14 words), where the streams keep
#: the packer's slack
PACK_CASES = {(6, 32768): 0.3, (5, 32767): 1.0, (2, 65536): 0.2}


@pytest.mark.parametrize("end_marker", [None, END], ids=["plain", "end"])
@pytest.mark.parametrize("b,m,zero_rows", [
    (4, 512, (1,)), (2, 1000, ()), (1, 64, (0,)),
    *[(b, m, "cases") for b, m in PACK_CASES]])
def test_pack_bits_batch_matches_jax(end_marker, b, m, zero_rows):
    if zero_rows == "cases":
        v, w = pack_units(m, b, m, PACK_CASES[b, m])
        cap = 1 << 16
    else:
        v, w = _units(b * 31 + m, b, m, zero_rows)
        cap = _cap(m)
    want = jbitpack.pack_bits_batch(jnp.asarray(v), jnp.asarray(w), cap,
                                    end_marker=end_marker)
    got = bitpack.pack_bits_batch(torch.from_numpy(v), torch.from_numpy(w),
                                  cap, end_marker=end_marker)
    assert got[0].dtype == torch.uint8
    for g, x in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(x))


def test_pack_all_zero_widths_is_only_the_end_marker():
    v = np.zeros((2, 256), np.int32)
    w = np.zeros((2, 256), np.int32)
    comp, total, offs = bitpack.pack_bits_batch(
        torch.from_numpy(v), torch.from_numpy(w), 64, end_marker=END)
    assert total.tolist() == [9, 9]
    assert not offs.any()
    assert comp[:, :2].tolist() == [[0xC0, 0x00]] * 2
    assert not comp[:, 2:].any()


def test_pack_rows_is_the_plain_version_on_cpu():
    v, w = _units(3, 3, 300)
    a = ppack.pack_rows(torch.from_numpy(v), torch.from_numpy(w), _cap(300),
                        END)
    b = ppack.pack_rows_plain(torch.from_numpy(v), torch.from_numpy(w),
                              _cap(300), END)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_pack_rejects_bad_capacity():
    v = torch.zeros((1, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        bitpack.pack_bits_batch(v, v, 30)
