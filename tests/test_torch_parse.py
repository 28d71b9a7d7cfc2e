"""lzs_tpu_torch: the container decode's lane parse (decode2._parse_full,
and _parse_flat, the form the decode runs).

The port's lane parse on CPU tensors (its plain version; a CUDA tensor
launches ``csrc/parse.cu``) against the JAX package's ``_parse_full``
(jit of a vmap over blocks), at tolerance 0 on both outputs: the records
and each lane's final output position. The parse is defined on any bytes
and any sync records, so the inputs are seeded numpy noise, not encoded
streams (``test_torch_decode.py`` covers JAX-encoded ones): a batch of 33
blocks (F4: batch >= 32) where some rows carry plausible records (sorted
bit offsets just before each span boundary) and the rest corrupt ones
(any bit offset in [0, 8C], any mode and offset bits, bit 31 set in some
rows, which makes the match offset negative); byte rows longer and
shorter than the lanes' L * span / 8 bytes (odd lengths too); one lane.
The decode's form, ``_parse_flat`` (lane-major records, below 0 as -1,
padded with -1), filled by the running max, is held to JAX's
``_filled_records`` of its ``_parse_full`` records, with ``out_final``,
at batch 33, lane counts that are not a multiple of 32, C % 4 != 0 and
the same corrupt records (whose negative records JAX clamps to -1 only in
the fill).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lzs_tpu.ops import decode2 as jdec2
from lzs_tpu_torch.ops import _kernels, decode2, pext

B = 33


def _inputs(seed, b, nslots, span, c):
    rng = np.random.default_rng(seed)
    comp = rng.integers(0, 256, (b, c), dtype=np.uint8)
    comp[0, : c // 2] = 0x41                # a long run of one literal
    sbit = rng.integers(0, 8 * c + 1, (b, nslots))
    plausible = np.arange(nslots) * span - rng.integers(0, 25, (b, nslots))
    sbit[: b // 2] = np.maximum(plausible[: b // 2], 0)
    sout = rng.integers(0, 1 << 31, (b, nslots), dtype=np.int64)
    sout[::5] |= 1 << 31                    # negative match offsets
    sout[1::3] &= ~(1 << 17)                # these lanes start in NORMAL
    sout = sout.astype(np.uint32).view(np.int32)
    return comp, sbit.astype(np.int32), sout


def _jax_parse(comp, sbit, sout, span):
    return jax.jit(jax.vmap(lambda c, b, o: jdec2._parse_full(c, b, o, span)))(
        jnp.asarray(comp), jnp.asarray(sbit), jnp.asarray(sout))


@pytest.mark.parametrize("span,nslots,extra", [
    (160, 12, 13),        # C past the lanes' L * wpl words
    (160, 12, -7),        # C short of them, not a multiple of 4
    (2048, 5, 40),
    (2048, 5, -258),      # the last lane's words lie past C
    (2048, 1, 0),         # one lane: it parses nothing
    (160, 1, 6),
])
def test_parse_matches_jax(span, nslots, extra):
    c = nslots * span // 8 + extra
    comp, sbit, sout = _inputs(span + nslots + extra, B, nslots, span, c)
    want_recs, want_final = _jax_parse(comp, sbit, sout, span)
    got_recs, got_final = decode2._parse_full(
        torch.from_numpy(comp), torch.from_numpy(sbit),
        torch.from_numpy(sout), span)
    assert got_recs.dtype == got_final.dtype == torch.int32
    assert got_recs.shape == (B, (span // 32 + 2) * 4, nslots)
    np.testing.assert_array_equal(got_recs.numpy(), np.asarray(want_recs))
    np.testing.assert_array_equal(got_final.numpy(), np.asarray(want_final))
    recs = got_recs.numpy()
    if nslots > 1:
        assert (recs >= 0).any() and (recs < -1).any()   # negative payloads
    else:
        assert (recs == -1).all()


@pytest.mark.parametrize("span,nslots,extra", [
    (160, 37, -7),        # 37 lanes, C = 733 (C % 4 == 1)
    (96, 33, 2),          # an odd number of word steps (5), C % 4 == 2
    (2048, 5, 41),
    (160, 1, 6),          # one lane: every record -1, all padding
])
def test_parse_flat_fill_matches_jax(span, nslots, extra):
    c = nslots * span // 8 + extra
    comp, sbit, sout = _inputs(span * nslots + extra, B, nslots, span, c)
    want_recs, want_final = _jax_parse(comp, sbit, sout, span)
    want_fill = np.asarray(jdec2._filled_records(want_recs))
    args = [torch.from_numpy(a) for a in (comp, sbit, sout)]
    flat, final = decode2._parse_flat_plain(*args, span)
    steps = (span // 32 + 2) * 4
    assert flat.dtype == final.dtype == torch.int32
    assert flat.shape == want_fill.shape == (
        B, max(-(-nslots * steps // 128) * 128, 768))
    assert (flat >= -1).all() and (flat[:, nslots * steps:] == -1).all()
    np.testing.assert_array_equal(
        pext.cummax_rows_plain(flat).numpy(), want_fill)
    np.testing.assert_array_equal(final.numpy(), np.asarray(want_final))
    # the records themselves: JAX's, lane-major, clamped
    recs = np.asarray(want_recs).transpose(0, 2, 1).reshape(B, -1)
    np.testing.assert_array_equal(flat[:, :recs.shape[1]].numpy(),
                                  np.maximum(recs, -1))
    if nslots > 1:
        assert (recs < -1).any()           # negative records, clamped


def test_parse_on_cpu_launches_nothing():
    comp, sbit, sout = _inputs(1, 4, 3, 160, 60)
    args = [torch.from_numpy(a) for a in (comp, sbit, sout)]
    _kernels.reset_launches()
    got = decode2._parse_full(*args, 160)
    assert not any(_kernels.launch_counts().values())
    for g, w in zip(got, decode2._parse_full_plain(*args, 160), strict=True):
        assert torch.equal(g, w)


def test_parse_flat_on_cpu_launches_nothing():
    comp, sbit, sout = _inputs(1, 4, 3, 160, 60)
    args = [torch.from_numpy(a) for a in (comp, sbit, sout)]
    _kernels.reset_launches()
    got = decode2._parse_flat(*args, 160)
    assert not any(_kernels.launch_counts().values())
    for g, w in zip(got, decode2._parse_flat_plain(*args, 160), strict=True):
        assert torch.equal(g, w)


def test_parse_rejects_mixed_devices():
    comp, sbit, sout = _inputs(2, 4, 3, 160, 60)
    with pytest.raises(ValueError, match="several devices"):
        decode2._parse_full(torch.from_numpy(comp),
                            torch.from_numpy(sbit).to("meta"),
                            torch.from_numpy(sout), 160)


def test_parse_flat_rejects_mixed_devices():
    comp, sbit, sout = _inputs(2, 4, 3, 160, 60)
    with pytest.raises(ValueError, match="several devices"):
        decode2._parse_flat(torch.from_numpy(comp),
                            torch.from_numpy(sbit).to("meta"),
                            torch.from_numpy(sout), 160)
