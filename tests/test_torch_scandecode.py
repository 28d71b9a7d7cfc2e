"""lzs_tpu_torch: the raw decoder's engine "scan" against JAX's.

The port's bit-serial parse on CPU tensors (``decode._parse_scan_plain``;
a CUDA tensor launches ``csrc/scan_parse.cu``, tests/test_torch_gpu.py),
its filled form (``decode._parse_scan_filled``, the records as JAX's
``_decode_batch`` fills them, bitwise) and its decode
(``decode_batch(engine="scan")``: the filled parse and the expansion,
each its plain version here, and no ``cummax_rows``) against the JAX
package's ``engine="scan"`` (its ``lax.scan`` parse; the fill and the
expansion as Pallas kernels in interpret mode), at tolerance 0 in (out,
out_len, end markers) and in the step records (JAX's ``_parse_scan``
units packed as its ``_decode_batch`` packs them, under one jit of a
vmap, which compiles in well under a second: a whole JAX decode compiles
for several seconds, so most cases hold the records to JAX and the bytes
to the port's engine "bits" or to the input; the fuzz set's whole decode
meets JAX's two engines in tests/test_torch_rawdecode.py, which compiles
them anyway). Inputs: the fuzz set of tests/test_torch_rawdecode.py
(batch 32, F4), single and multi-stream;
step budgets at the default, at the JAX CLI's ``in_cap * 2 + 16`` and
two that cut streams; every truncation of one stream; the out_cap clamp
and a block of exactly out_cap bytes (no end marker read); a copy from
before the block start (zero fill); input lengths past the row; the host
helper and the entry points with ``engine`` and ``max_units``.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lzs_tpu import reference as ref
from lzs_tpu import spec
from lzs_tpu.ops import decode as jdecode
from lzs_tpu.ops import decode2 as jdecode2
from lzs_tpu_torch.ops import decode, pext

from test_torch_rawdecode import _assert_equal, _batch, fuzz  # noqa: F401


@functools.partial(jax.jit, static_argnames=("out_cap", "max_units",
                                             "multi_stream"))
def _jax_units(comp, inbytes, *, out_cap, max_units, multi_stream):
    return jax.vmap(lambda c, m: jdecode._parse_scan(
        c, m, out_cap=out_cap, max_units=max_units,
        multi_stream=multi_stream))(comp, inbytes)


def _budget(out_cap, max_units):
    return decode.default_max_units(out_cap) if max_units is None \
        else max_units


def _jax_records(buf, lens, *, out_cap, max_units=None, multi_stream=False):
    """JAX's step records (as its _decode_batch packs them), out_len and
    end markers."""
    kind, val, off, length, opos, out_len, markers = (
        np.asarray(a) for a in _jax_units(
            jnp.asarray(buf), jnp.asarray(lens), out_cap=out_cap,
            max_units=_budget(out_cap, max_units),
            multi_stream=multi_stream))
    pay = np.where(kind == 1, val, off)
    rec = np.where(length > 0, (opos << 13)
                   | ((kind == 2).astype(np.int32) << 11) | pay, -1)
    return [rec.astype(np.int32), out_len, markers]


def _jax_filled(buf, lens, **kw):
    """JAX's record fill of its step records, as its _decode_batch makes
    it (_filled_records of rec[:, :, None]), out_len and end markers."""
    rec, out_len, markers = _jax_records(buf, lens, **kw)
    return [np.asarray(jdecode2._filled_records(jnp.asarray(rec)[:, :, None])),
            out_len, markers]


def _port_filled(buf, lens, *, out_cap, max_units=None, multi_stream=False):
    return [t.numpy() for t in decode._parse_scan_filled(
        torch.from_numpy(buf), torch.from_numpy(lens), out_cap=out_cap,
        max_units=_budget(out_cap, max_units), multi_stream=multi_stream)]


def _port_records(buf, lens, *, out_cap, max_units=None, multi_stream=False):
    return [t.numpy() for t in decode._parse_scan(
        torch.from_numpy(buf), torch.from_numpy(lens), out_cap=out_cap,
        max_units=_budget(out_cap, max_units), multi_stream=multi_stream)]


def _port(buf, lens, engine="scan", **kw):
    return [t.numpy() for t in decode.decode_batch(
        torch.from_numpy(buf), torch.from_numpy(lens), engine=engine, **kw)]


def _jax(buf, lens, **kw):
    return [np.asarray(a) for a in jdecode.decode_batch(
        jnp.asarray(buf), jnp.asarray(lens), engine="scan", **kw)]


def _records_match_jax(buf, lens, **kw):
    got = _port_records(buf, lens, **kw)
    _assert_equal(got, _jax_records(buf, lens, **kw))
    return got


@pytest.mark.parametrize("multi", [False, True])
def test_fuzz_matches_jax_scan(fuzz, multi):
    buf, lens, datas = fuzz
    assert len(lens) >= 32
    got = _port(buf, lens, out_cap=2048, multi_stream=multi)
    recs, out_len, markers = _records_match_jax(buf, lens, out_cap=2048,
                                                multi_stream=multi)
    np.testing.assert_array_equal(out_len, got[1])
    np.testing.assert_array_equal(markers, got[2])
    for i, d in enumerate(datas):
        assert got[0][i, :got[1][i]].tobytes() == d
    joined = datas[0] + datas[1] if multi else datas[0]
    assert got[0][30, :got[1][30]].tobytes() == joined
    assert got[2][30] == (2 if multi else 1)


@pytest.mark.parametrize("multi", [False, True])
def test_fuzz_matches_port_bits(fuzz, multi):
    buf, lens, _ = fuzz
    _assert_equal(_port(buf, lens, out_cap=2048, multi_stream=multi),
                  _port(buf, lens, "bits", out_cap=2048,
                        multi_stream=multi))


@pytest.mark.parametrize("budget", ["default", "cli", 300, 40])
def test_max_units_matches_jax(fuzz, budget):
    """The step budget: the default and the JAX CLI's cut no stream of the
    set (the bytes equal engine "bits"'s); 300 and 40 steps cut some and
    most (the bytes a prefix of the full decode's, and at 40 JAX's whole
    decode)."""
    buf, lens, _ = fuzz
    max_units = {"default": decode.default_max_units(2048),
                 "cli": buf.shape[1] * 2 + 16}.get(budget, budget)
    got = _port(buf, lens, out_cap=2048, max_units=max_units,
                multi_stream=True)
    recs, out_len, markers = _records_match_jax(
        buf, lens, out_cap=2048, max_units=max_units, multi_stream=True)
    assert recs.shape == (len(lens), max_units)
    np.testing.assert_array_equal(got[1], out_len)
    np.testing.assert_array_equal(got[2], markers)
    full = _port(buf, lens, "bits", out_cap=2048, multi_stream=True)
    cut = (got[1] < full[1]).sum()
    if budget in ("default", "cli"):
        assert cut == 0
        _assert_equal(got, full)
    else:
        assert cut >= (10 if budget == 40 else 3)
        for row, m, whole in zip(got[0], got[1], full[0]):
            assert row[:m].tobytes() == whole[:m].tobytes()
            assert not row[m:].any()
    if budget == 40:
        _assert_equal(got, _jax(buf, lens, out_cap=2048, max_units=40,
                                multi_stream=True))


@pytest.mark.parametrize("multi", [False, True])
def test_every_truncation_matches_jax(multi):
    stream = ref.lzs_compress(b"some data to compress some data" * 3
                              + bytes(range(40)))
    full = ref.lzs_decompress(stream)
    buf, lens = _batch([stream[:cut] for cut in range(len(stream) + 1)])
    got = _port(buf, lens, out_cap=4096, multi_stream=multi)
    _records_match_jax(buf, lens, out_cap=4096, multi_stream=multi)
    _assert_equal(got, _port(buf, lens, "bits", out_cap=4096,
                             multi_stream=multi))
    for row, m in zip(got[0], got[1]):
        assert full.startswith(row[:m].tobytes())
    assert got[0][-1, :got[1][-1]].tobytes() == full and got[2][-1] == 1


def test_out_cap_clamp_and_exact_block_match_jax():
    """Lengths cut to out_cap - out_count (a copy and a literal run past
    out_cap), and a block of exactly out_cap bytes, which stops with its
    output full and reads no end marker (one byte shorter reads it)."""
    rng = np.random.default_rng(3)
    lits = rng.integers(0, 256, 150, dtype=np.uint8).tobytes()
    datas = [b"R" * 300, lits, lits[:100], lits[:99],
             b"ab" * 50, b"ab" * 49 + b"a"]
    buf, lens = _batch([ref.lzs_compress(d) for d in datas])
    got = _port(buf, lens, out_cap=100)
    _assert_equal(got, _jax(buf, lens, out_cap=100))
    _records_match_jax(buf, lens, out_cap=100)
    for row, m, d in zip(got[0], got[1], datas):
        assert row[:m].tobytes() == d[:100]
    assert got[2].tolist() == [0, 0, 0, 1, 0, 1]


def test_zero_fill_corrupt_offset():
    w = ref.BitWriter()
    w.put(1, 1)
    w.put(1, 1)
    w.put(9, 7)                          # offset 9 with empty history
    w.put(0b1100, 4)                     # length 5
    w.put(ord("z"), 9)                   # a literal
    w.put(spec.END_MARKER_VALUE, spec.END_MARKER_BITS)
    w.pad_to_byte()
    stream = w.getvalue()
    assert decode.decode_bytes(stream, 4096, engine="scan",
                               device="cpu") == b"\x00" * 5 + b"z"
    buf, lens = _batch([stream])
    _records_match_jax(buf, lens, out_cap=4096)


def test_host_helper_and_entry_points_take_engine_and_max_units():
    a, b = b"first stream data " * 3, b"second one " * 5
    stream = ref.lzs_compress(a) + ref.lzs_compress(b)
    for multi, want in ((True, a + b), (False, a)):
        assert decode.decode_bytes(stream, 4096, multi_stream=multi,
                                   engine="scan", device="cpu") == want
    cut = decode.decode_bytes(stream, 4096, multi_stream=True,
                              engine="scan", max_units=10, device="cpu")
    assert 0 < len(cut) < len(a) and a.startswith(cut)
    buf, lens = _batch([stream])
    t, n = torch.from_numpy(buf), torch.from_numpy(lens)
    want = decode.decode_batch(t, n, out_cap=4096, max_units=10,
                               multi_stream=True, engine="scan")
    assert want[0][0, :want[1][0]].numpy().tobytes() == cut
    one = decode.decode_block(t[0], n[0], out_cap=4096, max_units=10,
                              multi_stream=True, engine="scan")
    dec = decode.make_decoder(buf.shape[1], 4096, max_units=10,
                              multi_stream=True, engine="scan")
    for got in (tuple(x[None] for x in one), dec(t, n)):
        assert all(torch.equal(g, w) for g, w in zip(got, want, strict=True))


def test_parse_scan_cpu_path_is_the_plain_version(fuzz):
    buf, lens, _ = fuzz
    t, n = torch.from_numpy(buf[:, :77]), torch.from_numpy(lens)
    got = decode._parse_scan(t, n, out_cap=500, max_units=600,
                             multi_stream=True)
    want = decode._parse_scan_plain(t, n, out_cap=500, max_units=600,
                                    multi_stream=True)
    assert all(torch.equal(g, w) for g, w in zip(got, want, strict=True))
    assert got[0].dtype == got[1].dtype == got[2].dtype == torch.int32
    # input lengths past the row: bytes past C read as zero in both
    assert (lens > 77).any()
    _records_match_jax(buf[:, :77], lens, out_cap=500, max_units=600,
                       multi_stream=True)
    with pytest.raises(ValueError, match="max_units"):
        decode.decode_batch(t, n, out_cap=500, max_units=-1, engine="scan")


def _truncations():
    stream = ref.lzs_compress(b"some data to compress some data" * 3
                              + bytes(range(40)))
    return _batch([stream[:cut] for cut in range(len(stream) + 1)])


def _unaligned(buf):
    """The rows widened with zeros to C % 4 == 3."""
    c = buf.shape[1] + (3 - buf.shape[1] % 4) % 4
    return np.pad(buf, ((0, 0), (0, c - buf.shape[1])))


@pytest.mark.parametrize("multi", [False, True])
@pytest.mark.parametrize("case", ["fuzz", "truncations", "budget",
                                  "unaligned", "narrow"])
def test_filled_matches_jax(fuzz, case, multi):
    """The decode's form of the parse (_parse_scan_filled: the records
    filled as JAX's _decode_batch fills them, -1 before the first, the last
    one through the pad of _flat_width) equals JAX's rows bitwise, with
    out_len and the end markers: the fuzz streams, every truncation of one
    stream, a budget of 300 steps that cuts, rows of C % 4 == 3, rows cut
    to 77 bytes at out_cap 500 and 600 steps."""
    buf, lens, _ = fuzz
    kw = {"out_cap": 2048, "multi_stream": multi}
    if case == "truncations":
        buf, lens = _truncations()
        kw["out_cap"] = 4096
    elif case == "budget":
        kw["max_units"] = 300
    elif case == "unaligned":
        buf = _unaligned(buf)
        assert buf.shape[1] % 4 == 3
    elif case == "narrow":
        buf = np.ascontiguousarray(buf[:, :77])
        kw.update(out_cap=500, max_units=600)
    assert len(lens) >= 32
    got = _port_filled(buf, lens, **kw)
    _assert_equal(got, _jax_filled(buf, lens, **kw))
    width = max((_budget(kw["out_cap"], kw.get("max_units")) + 127) & ~127,
                768)
    assert got[0].shape == (len(lens), width)
    if case == "budget":
        assert (got[1] < _port(buf, lens, "bits", **kw)[1]).sum() >= 3


def test_scan_decode_runs_no_record_fill(fuzz, monkeypatch):
    """decode_batch(engine="scan") takes the parse's filled rows as they
    are: no cummax_rows (K8 on the card) runs on its path."""
    buf, lens, datas = fuzz

    def no_fill(v):
        raise AssertionError("cummax_rows ran on the scan decode's path")

    monkeypatch.setattr(pext, "cummax_rows", no_fill)
    got = _port(buf, lens, out_cap=2048)
    for i, d in enumerate(datas):
        assert got[0][i, :got[1][i]].tobytes() == d
    monkeypatch.undo()
    _assert_equal(got, _port(buf, lens, "bits", out_cap=2048))
