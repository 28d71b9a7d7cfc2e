"""lzs_tpu_torch: the raw-stream decoder (decode, bitpar) against JAX.

Raw LZS streams go through ``lzs_tpu.ops.decode.decode_batch`` (engine
"bits": its Pallas walk, cumsum, cummax and expansion kernels in
interpret mode; and engine "scan", the bit-serial oracle) and through the
port's ``decode_batch`` on CPU tensors (every kernel's plain version),
each port engine against each JAX engine on the fuzz set
(tests/test_torch_scandecode.py has the rest of engine "scan").
Bytes, output lengths and end-marker counts must be equal (tolerance 0)
at batch >= 32 with both ``multi_stream`` values, on the fuzz set of
tests/test_ops.py (concatenated and truncated rows included), the edge
cases of tests/test_ops.py, a 2^18-byte output checked against
``lzs_tpu.reference``, and the port's own block payloads through
``BlockCodec.decode_batch_raw``. Past 2^18 output bytes, where JAX's
decoder corrupts its output (ROADMAP F9), engine "bits" expands in
windows: held to the one-row expansion with narrow windows, and to
``lzs_tpu.reference`` and the input at out_cap 2^19 and 2^20. An input
wider than ``bitpar._WIN`` decodes in windows of the input: held bitwise
to the one-pass decode (``_WIN`` and ``_MARGIN`` cut to a few KiB or
bytes) at batch >= 33 in both modes, on every window cut of a short
chain, and where a run of extension nibbles longer than the span is cut
into a record a window (hand-built long tokens: short and long offsets,
every bit phase, three terminators, every truncation across two window
boundaries, batch 39, a margin of 8 bytes), no span wider than ``_WIN +
_MARGIN``; its bytes to ``lzs_tpu.reference`` and ``utils.native``'s C
decoder.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lzs_tpu import reference as ref
from lzs_tpu import spec
from lzs_tpu.blocks import BlockCodec as JaxBlockCodec
from lzs_tpu.ops import bitpar as jbitpar
from lzs_tpu.ops import decode as jdecode
from lzs_tpu.utils import native
from lzs_tpu_torch import convert
from lzs_tpu_torch.blocks import BlockCodec, pad_blocks
from lzs_tpu_torch.ops import _kernels, bitpar, decode

from test_torch_cases import heads_rows, raw_fuzz


def _batch(streams):
    cap = max(len(s) for s in streams) + 8
    buf = np.zeros((len(streams), cap), np.uint8)
    lens = np.zeros(len(streams), np.int32)
    for i, s in enumerate(streams):
        buf[i, :len(s)] = np.frombuffer(s, np.uint8)
        lens[i] = len(s)
    return buf, lens


def _port(buf, lens, **kw):
    return [t.numpy() for t in decode.decode_batch(
        torch.from_numpy(buf), torch.from_numpy(lens), **kw)]


def _jax(buf, lens, **kw):
    return [np.asarray(a) for a in jdecode.decode_batch(
        jnp.asarray(buf), jnp.asarray(lens), **kw)]


def _assert_equal(got, want):
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g, w.astype(g.dtype))
        assert g.dtype == w.dtype or (g.dtype == np.uint8 and w.max() < 256)


@pytest.fixture(scope="module")
def fuzz():
    """The fuzz set of test_ops.test_bitpar_matches_scan_engine: 30
    streams of random, RLE, periodic and already-compressed data, two
    concatenated streams and a truncated one (batch 32)."""
    rng = np.random.default_rng(7)
    datas = []
    for _ in range(30):
        kind = rng.integers(0, 4)
        n = int(rng.integers(0, 700))
        if kind == 0:
            d = bytes(rng.integers(0, 256, n, dtype=np.uint8))
        elif kind == 1:
            d = bytes([int(rng.integers(0, 4))]) * n
        elif kind == 2:
            seed = bytes(rng.integers(97, 123, 13, dtype=np.uint8))
            d = (seed * (n // len(seed) + 1))[:n]
        else:
            d = ref.lzs_compress(bytes(rng.integers(0, 256, n,
                                                    dtype=np.uint8)))
        datas.append(d)
    streams = [ref.lzs_compress(d) for d in datas]
    streams.append(streams[0] + streams[1])
    streams.append(streams[2][:max(len(streams[2]) // 2, 1)])
    buf, lens = _batch(streams)
    return buf, lens, datas


@pytest.mark.parametrize("multi", [False, True])
@pytest.mark.parametrize("engine", ["bits", "scan"])
def test_fuzz_matches_jax_engines(fuzz, multi, engine):
    buf, lens, datas = fuzz
    assert len(lens) >= 32
    got = _port(buf, lens, out_cap=2048, multi_stream=multi)
    _assert_equal(got, _jax(buf, lens, out_cap=2048, multi_stream=multi,
                            engine=engine))
    for i, d in enumerate(datas):
        assert got[0][i, :got[1][i]].tobytes() == d
    joined = datas[0] + datas[1] if multi else datas[0]
    assert got[0][30, :got[1][30]].tobytes() == joined
    assert got[2][30] == (2 if multi else 1)


@pytest.mark.parametrize("multi", [False, True])
@pytest.mark.parametrize("engine", ["bits", "scan"])
def test_fuzz_port_scan_matches_jax_engines(fuzz, multi, engine):
    buf, lens, datas = fuzz
    got = _port(buf, lens, out_cap=2048, multi_stream=multi, engine="scan")
    _assert_equal(got, _jax(buf, lens, out_cap=2048, multi_stream=multi,
                            engine=engine))
    for i, d in enumerate(datas):
        assert got[0][i, :got[1][i]].tobytes() == d
    assert got[2][30] == (2 if multi else 1)


@pytest.mark.parametrize("multi", [False, True])
def test_make_decoder_equals_decode_batch(fuzz, multi):
    buf, lens, _ = fuzz
    dec = decode.make_decoder(buf.shape[1], 2048, multi_stream=multi)
    got = [t.numpy() for t in dec(torch.from_numpy(buf),
                                  torch.from_numpy(lens))]
    _assert_equal(got, _port(buf, lens, out_cap=2048, multi_stream=multi))
    jdec = jdecode.make_decoder(buf.shape[1], 2048, multi_stream=multi)
    _assert_equal(got, [np.asarray(a) for a in jdec(jnp.asarray(buf),
                                                    jnp.asarray(lens))])


def _entry_call(entry, mod, buf, lens, max_units):
    """One decode of the fuzz batch through ``entry`` of ``mod`` (the
    port's or JAX's ``ops.decode``) with ``max_units``: decode_batch and
    make_decoder take the batch, decode_block its concatenated row."""
    arr = torch.from_numpy if mod is decode else jnp.asarray
    if entry == "decode_block":
        out = mod.decode_block(arr(buf[30]), arr(lens[30:31])[0],
                               out_cap=2048,
                               max_units=max_units,
                               multi_stream=True)
        return [np.asarray(t) for t in out]
    fn = (mod.make_decoder(buf.shape[1], 2048, max_units=max_units)
          if entry == "make_decoder"
          else functools.partial(mod.decode_batch, out_cap=2048,
                                 max_units=max_units))
    return [np.asarray(t) for t in fn(arr(buf), arr(lens))]


@pytest.mark.parametrize("budget", ["none", "default", "cli"])
@pytest.mark.parametrize("entry", ["decode_batch", "decode_block",
                                   "make_decoder"])
def test_max_units_matches_jax_bits_engine(fuzz, entry, budget):
    """Each entry point takes JAX's ``max_units=`` (None, the default
    budget, and the JAX CLI's ``in_cap * 2 + 16``) and gives what JAX's
    bits engine gives with the same argument."""
    buf, lens, _ = fuzz
    max_units = {"none": None,
                 "default": decode.default_max_units(2048),
                 "cli": buf.shape[1] * 2 + 16}[budget]
    got = _entry_call(entry, decode, buf, lens, max_units)
    _assert_equal(got, _entry_call(entry, jdecode, buf, lens, max_units))
    assert decode.default_max_units(2048) == jdecode.default_max_units(2048)


def test_multi_stream_decode():
    a, b = b"first stream data " * 3, b"second one " * 5
    stream = ref.lzs_compress(a) + ref.lzs_compress(b)
    assert decode.decode_bytes(stream, 4096, multi_stream=True,
                               device="cpu") == a + b
    assert decode.decode_bytes(stream, 4096, multi_stream=False,
                               device="cpu") == a


def test_zero_fill_corrupt_offset():
    w = ref.BitWriter()
    w.put(1, 1)
    w.put(1, 1)
    w.put(9, 7)                          # offset 9 with empty history
    w.put(0b1100, 4)                     # length 5
    w.put(spec.END_MARKER_VALUE, spec.END_MARKER_BITS)
    w.pad_to_byte()
    assert decode.decode_bytes(w.getvalue(), 4096, device="cpu") == b"\x00" * 5


@pytest.mark.parametrize("multi", [False, True])
def test_every_truncation_matches_jax(multi):
    stream = ref.lzs_compress(b"some data to compress some data")
    full = ref.lzs_decompress(stream)
    buf, lens = _batch([stream[:cut] for cut in range(len(stream))])
    got = _port(buf, lens, out_cap=4096, multi_stream=multi)
    _assert_equal(got, _jax(buf, lens, out_cap=4096, multi_stream=multi))
    for row, m in zip(got[0], got[1]):
        assert full.startswith(row[:m].tobytes())


def test_output_capacity_clamp():
    data = b"R" * 300
    stream = ref.lzs_compress(data)
    assert decode.decode_bytes(stream, 100, device="cpu") == data[:100]
    out, out_len, markers = decode.decode_block(
        torch.from_numpy(np.frombuffer(stream, np.uint8).copy()),
        torch.tensor(len(stream), dtype=torch.int32), out_cap=100)
    assert out.shape == (100,) and int(out_len) == 100 and int(markers) == 0


@pytest.mark.parametrize("period", [1, 3, 27, 1999])
def test_long_single_record_copy(period):
    seed = bytes(i % 251 for i in range(period)) if period > 1 else b"Q"
    data = (seed * (8192 // len(seed) + 1))[:8192]
    assert decode.decode_bytes(ref.lzs_compress(data), 8192,
                               device="cpu") == data


@pytest.mark.parametrize("shape", [(32, 1), (32, 7), (32, 16), (32, 17),
                                   (32, 4, 100), (32, 1001)])
def test_seg_reverse_sum_matches_jax(shape):
    rng = np.random.default_rng(sum(shape))
    a = rng.integers(0, 16, shape).astype(np.int32)
    g = (rng.random(shape) < 0.8).astype(np.int32)
    want = np.asarray(jbitpar._seg_reverse_sum(jnp.asarray(a),
                                               jnp.asarray(g)))
    got = bitpar._seg_reverse_sum(torch.from_numpy(a), torch.from_numpy(g))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("c0,cpad", [(37, 40), (1024, 1024), (1100, 1024)])
def test_bit_windows_match_jax(c0, cpad):
    comp = np.random.default_rng(c0).integers(0, 256, (32, c0),
                                              dtype=np.uint8)
    want = np.asarray(jbitpar._bit_windows(jnp.asarray(comp), cpad))
    got = bitpar._bit_windows(torch.from_numpy(comp), cpad)
    assert got.dtype == torch.int32 and got.shape == (32, 8 * cpad)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


@pytest.mark.parametrize("multi", [False, True])
def test_heads_on_cpu_is_plain(multi):
    """On CPU tensors ``_heads`` is ``_heads_plain`` and launches nothing:
    the raw fuzz batch, and rows of several 16384-bit tiles with
    continuation heads (the heads kernel's test inputs on the card)."""
    before = _kernels.RAW_HEADS.launches
    buf, lens = raw_fuzz(7)
    comp, inbits = torch.from_numpy(buf), torch.from_numpy(lens * 8)[:, None]
    nbits = 8 * bitpar._padded(buf.shape[1])
    for got, want in zip(bitpar._heads(comp, inbits, nbits, 2048, multi),
                         bitpar._heads_plain(comp, inbits, nbits, 2048,
                                             multi), strict=True):
        assert torch.equal(got, want)
    rows, inbits = heads_rows(5, 3 * 2048 + 1000)
    b = len(rows)
    carry = (torch.arange(b, dtype=torch.int32) % 8,
             torch.tensor([(1, 2047, -1)[i % 3] for i in range(b)],
                          dtype=torch.int32))
    args = (torch.from_numpy(rows), torch.from_numpy(inbits)[:, None],
            8 * rows.shape[1], 300, multi, carry)
    for got, want in zip(bitpar._heads(*args), bitpar._heads_plain(*args),
                         strict=True):
        assert torch.equal(got, want)
    assert _kernels.RAW_HEADS.launches == before


def test_decode_block_at_max_out_cap_matches_reference():
    rng = np.random.default_rng(11)
    text = bytes(range(32, 127)) * 100
    parts = []
    for k in rng.integers(0, len(text) - 800, 200):
        parts.append(bytes(rng.integers(0, 256, int(rng.integers(1, 3000)),
                                        dtype=np.uint8)))
        parts.append(text[int(k):int(k) + int(rng.integers(50, 800))])
    data = b"".join(parts)[:bitpar.MAX_OUT_CAP - 2000]
    stream = native.compress(data)
    assert len(stream) > 180_000
    want = ref.lzs_decompress(stream)
    assert want == data
    assert decode.decode_bytes(stream, bitpar.MAX_OUT_CAP,
                               device="cpu") == want


@pytest.mark.parametrize("engine", ["bits", "scan"])
def test_out_cap_over_max_raises(engine):
    """Past 2^18 output bytes a record's opos << 13 leaves int32 (F9):
    engine "scan" refuses such an out_cap, through every entry point;
    engine "bits" expands in windows there and refuses an out_cap past
    its own bound, 2^30."""
    buf = torch.zeros((1, 8), dtype=torch.uint8)
    n = torch.zeros(1, dtype=torch.int32)
    if engine == "scan":
        over, match = bitpar.MAX_OUT_CAP + 1, "opos << 13"
    else:
        over, match = bitpar.MAX_WIDE_OUT_CAP + 1, "outside"
    for max_units in (None, decode.default_max_units(64), 32):
        with pytest.raises(ValueError, match=match):
            decode.decode_batch(buf, n, out_cap=over, max_units=max_units,
                                engine=engine)
        with pytest.raises(ValueError, match=match):
            decode.decode_block(buf[0], n[0], out_cap=over,
                                max_units=max_units, engine=engine)
        with pytest.raises(ValueError, match=match):
            decode.make_decoder(8, over, max_units=max_units,
                                engine=engine)(buf, n)
    with pytest.raises(ValueError, match=match):
        decode.decode_bytes(b"", over, engine=engine, device="cpu")
    with pytest.raises(ValueError):
        bitpar.decode_batch_bits(buf, n, out_cap=0)


def _wide_chains():
    """Chains whose decodes cross many narrow windows: text, 15000 zeros
    (copies that run across windows) and text again as one multi-stream
    chain; one long stream; noise; an empty row; the zeros alone."""
    from test_stream import mixed_data

    data = mixed_data(9, 20000)
    parts = [native.compress(data[:7000]), native.compress(bytes(15000)),
             native.compress(data[7000:])]
    noise = np.random.default_rng(5).integers(0, 256, 3000, dtype=np.uint8)
    return [b"".join(parts), native.compress(data), noise.tobytes(), b"",
            parts[1]]


@pytest.mark.parametrize("multi", [False, True])
@pytest.mark.parametrize("rows", ["fuzz", "chains"])
def test_wide_windows_equal_one_row(fuzz, monkeypatch, multi, rows):
    """The windowed expansion equals the one-row expansion, bitwise
    (bytes, lengths, end markers): with windows of 256 new bytes behind
    the 2048 bytes of history (``_ROW`` cut to 2304), on the fuzz set
    (batch 32) and on chains of text, zeros and noise, at out_caps that
    end inside a window and past every output."""
    if rows == "fuzz":
        buf, lens = fuzz[:2]
        caps = (2305, 4096)
    else:
        buf, lens = _batch(_wide_chains())
        caps = (12293, 65536)
    for out_cap in caps:
        want = _port(buf, lens, out_cap=out_cap, multi_stream=multi)
        with monkeypatch.context() as m:
            m.setattr(bitpar, "_ROW", 2304)
            got = _port(buf, lens, out_cap=out_cap, multi_stream=multi)
        _assert_equal(got, want)
    # some row's output spans three windows or more
    assert want[1].max() > 2 * (2304 - 2048)


def test_decode_past_2_18_equals_reference():
    """Engine "bits" past 2^18 output bytes at full width, where JAX's
    decoder goes to its scan engine and corrupts the output from 2^18 on
    (F9): 300000 bytes at out_cap 2^19 and 600000 zeros at 2^20 equal
    the input and ``lzs_tpu.reference``, through decode_bytes and a
    batch of both rows."""
    from test_stream import mixed_data

    datas = [mixed_data(9, 300000), bytes(600000)]
    streams = [native.compress(d) for d in datas]
    for d, st, cap in zip(datas, streams, (1 << 19, 1 << 20)):
        assert decode.decode_bytes(st, cap, device="cpu") == d
        assert ref.lzs_decompress(st) == d
    buf, lens = _batch(streams)
    out, out_len, markers = _port(buf, lens, out_cap=1 << 20)
    for i, d in enumerate(datas):
        assert out[i, :out_len[i]].tobytes() == d
        assert not out[i, out_len[i]:].any()
    assert list(markers) == [1, 1]


def test_wide_input_bound_raises(monkeypatch):
    """The input is not bounded: past ``_WIN`` it decodes in windows at
    any out_cap (a window's span, at most ``_WIN + _MARGIN`` bytes, is
    held to ``MAX_WIDE_INPUT``, which keeps its sums in int32). A token
    whose run of extension nibbles passes the span decodes too, cut into
    one record a window, where no out_cap cuts it (``decode_to_host``)
    as under an out_cap (the token's head fills the output, which ends
    the decode)."""
    monkeypatch.setattr(bitpar, "_WIN", 256)
    monkeypatch.setattr(bitpar, "_MARGIN", 64)
    zeros = native.compress(bytes(15000))
    buf, lens = _batch([zeros, b""])
    for out_cap in (64, bitpar.MAX_OUT_CAP + 1):
        out, out_len, markers = _port(buf, lens, out_cap=out_cap)
        assert out.shape == (2, out_cap)
        assert list(out_len) == [min(out_cap, 15000), 0]
        assert not out.any()
        assert list(markers) == [int(out_cap > 15000), 0]
    monkeypatch.setattr(bitpar, "MAX_WIDE_INPUT", 320)
    assert bitpar.decode_to_host(torch.from_numpy(np.frombuffer(
        zeros, np.uint8).copy())) == ref.lzs_decompress(zeros) == bytes(
            15000)
    got = _port(buf, lens, out_cap=5000)
    assert list(got[1]) == [5000, 0] and not got[0].any()


@pytest.mark.parametrize("out_cap", [64, bitpar.MAX_OUT_CAP])
def test_scan_engine_decodes_up_to_max_out_cap(out_cap):
    """Engine "scan" runs at any out_cap up to 2^18, as engine "bits"."""
    stream = ref.lzs_compress(b"scan " * 20)
    buf, lens = _batch([stream, b""])
    want = _port(buf, lens, out_cap=out_cap)
    for max_units in (None, 32):
        got = _port(buf, lens, out_cap=out_cap, max_units=max_units,
                    engine="scan")
        if max_units is None:
            _assert_equal(got, want)
        assert got[0].shape == (2, out_cap) and got[1][1] == 0
    assert decode.decode_bytes(stream, out_cap, engine="scan",
                               device="cpu") == (b"scan " * 20)[:out_cap]


def test_unknown_engine_raises():
    buf = torch.zeros((1, 8), dtype=torch.uint8)
    n = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="unknown engine"):
        decode.decode_batch(buf, n, out_cap=64, engine="serial")
    with pytest.raises(ValueError, match="unknown engine"):
        decode.decode_block(buf[0], n[0], out_cap=64, engine="Scan")
    with pytest.raises(ValueError, match="unknown engine"):
        decode.make_decoder(8, 64, engine="lanes")(buf, n)


def test_block_codec_decode_batch_raw_matches_jax():
    rng = np.random.default_rng(5)
    block = 2048
    data = (bytes(range(64)) * 30 + b"Q" * 1500
            + rng.integers(0, 256, 1800, dtype=np.uint8).tobytes()
            + b"the quick brown fox " * 120)[:4 * block - 300]
    codec = BlockCodec(block=block, device="cpu")
    x, lens = pad_blocks(data, block)
    comp, clen, _, _, _ = codec.encode_batch(torch.from_numpy(x),
                                             torch.from_numpy(lens))
    out, out_len, markers = codec.decode_batch_raw(comp, clen)
    assert out.shape == (len(lens), block)
    assert out_len.tolist() == lens.tolist()
    # a full block's end marker lies at out_cap = block, past the output:
    # it is not read (the scan oracle stops when the output is full)
    assert markers.tolist() == (lens < block).astype(int).tolist()
    assert b"".join(out[i, :lens[i]].numpy().tobytes()
                    for i in range(len(lens))) == data

    jcodec = JaxBlockCodec(block=block)
    want = jcodec.decode_batch_raw(jnp.asarray(comp.numpy()),
                                   jnp.asarray(clen.numpy()))
    got = convert.batch_to_numpy({"out_len": out_len, "markers": markers})
    np.testing.assert_array_equal(out.numpy(),
                                  np.asarray(want[0]).astype(np.uint8))
    np.testing.assert_array_equal(got["out_len"], np.asarray(want[1]))
    np.testing.assert_array_equal(got["markers"], np.asarray(want[2]))
    moved = convert.batch_to_torch(
        {"comp": np.asarray(comp), "clen": np.asarray(clen)}, "cpu")
    again = codec.decode_batch_raw(moved["comp"], moved["clen"])
    assert torch.equal(again[0], out)


def _in_windows(monkeypatch, win, margin, fn, row=None):
    """fn() with ``_WIN`` and ``_MARGIN`` cut to ``win`` and ``margin``
    (and ``_ROW``, the output's expansion windows, to ``row`` if given),
    and the spans of the windows it took (``_heads``' widths)."""
    spans = []
    heads = bitpar._heads

    def spy(comp, *args, **kw):
        spans.append(comp.shape[1])
        return heads(comp, *args, **kw)

    with monkeypatch.context() as m:
        m.setattr(bitpar, "_WIN", win)
        m.setattr(bitpar, "_MARGIN", margin)
        m.setattr(bitpar, "_heads", spy)
        if row is not None:
            m.setattr(bitpar, "_ROW", row)
        return fn(), spans


def _decoded(stream: bytes, multi: bool) -> bytes:
    """The C decoder of the JAX package's ``utils.native``, reading on
    past each end marker or stopping at the first; where the stream is
    whole and ends at its first marker, ``lzs_tpu.reference`` too."""
    got = native.decompress(stream, out_cap=1 << 20, multi_stream=multi)
    try:
        whole = ref.lzs_decompress(stream)
    except EOFError:          # the reference reads no cut stream
        return got
    if not multi or got == whole:
        assert got == whole
    return got


@pytest.fixture(scope="module")
def rows37(fuzz):
    """The fuzz set's 32 rows and the 5 chains of ``_wide_chains``
    (text, zeros and noise over many windows): batch 37."""
    buf, lens, _ = fuzz
    streams = [buf[i, :lens[i]].tobytes() for i in range(len(lens))]
    streams += _wide_chains()
    return (*_batch(streams), streams)


@pytest.mark.parametrize("multi", [False, True])
@pytest.mark.parametrize("win,margin", [(2048, 256), (512, 64)])
def test_input_windows_equal_one_pass(monkeypatch, rows37, multi, win,
                                      margin):
    """Rows wider than ``_WIN`` decode in windows of ``_WIN`` bytes over
    the rows still decoding: bitwise the one-pass decode (bytes, lengths,
    end markers) at batch 37, at out_caps that end inside a window's
    output, past 2^18 (the wide records) and past every output; each
    row's bytes are the JAX package's decoders'."""
    buf, lens, streams = rows37
    assert len(lens) >= 33
    for out_cap in (2305, 40000, bitpar.MAX_OUT_CAP + 4096):
        want = _port(buf, lens, out_cap=out_cap, multi_stream=multi)
        got, spans = _in_windows(
            monkeypatch, win, margin,
            lambda: _port(buf, lens, out_cap=out_cap, multi_stream=multi))
        _assert_equal(got, want)
        assert len(spans) > 3
    for i, st in enumerate(streams):
        assert got[0][i, :got[1][i]].tobytes() == _decoded(st, multi)


def test_every_window_cut_equals_one_pass(monkeypatch):
    """A short chain (text, a run of zeros, text, as three streams) at
    every window width from 1 byte to its length behind an 8-byte margin:
    its windows end at most of its heads and inside its tokens, and each
    decode equals the one-pass decode bitwise in both modes."""
    from test_stream import mixed_data

    data = mixed_data(3, 700)
    chain = (native.compress(data[:300]) + native.compress(bytes(600))
             + native.compress(data[300:]))
    buf, lens = _batch([chain])
    for multi in (False, True):
        want = _port(buf, lens, out_cap=4096, multi_stream=multi)
        assert want[0][0, :want[1][0]].tobytes() == _decoded(chain, multi)
        for win in range(1, len(chain) - 8):
            got, spans = _in_windows(
                monkeypatch, win, 8,
                lambda: _port(buf, lens, out_cap=4096, multi_stream=multi))
            _assert_equal(got, want)
            # a single stream ends at its first marker, in the first span
            # that holds it
            assert len(spans) > 1 or not multi


@pytest.mark.parametrize("out_cap", [100, 5000, 14999, 20000])
def test_nibble_run_past_the_span_grows_it(monkeypatch, out_cap):
    """15000 zeros are one copy whose run of 15-nibbles (some 500 bytes)
    is longer than a window's span (64 + 16 bytes): no span grows past
    it; the window cuts the run, emits the copy up to the cut, and the
    next one goes on from there, until the run ends or the cut chain
    already fills the out_cap. Bitwise the one-pass decode and the
    reference's bytes."""
    stream = native.compress(bytes(15000))
    buf, lens = _batch([stream])
    want = _port(buf, lens, out_cap=out_cap)
    got, spans = _in_windows(monkeypatch, 64, 16,
                             lambda: _port(buf, lens, out_cap=out_cap))
    _assert_equal(got, want)
    assert got[0][0, :got[1][0]].tobytes() == bytes(min(out_cap, 15000))
    assert max(spans) <= 64 + 16
    # a window emits at most 30 bytes an input byte of its span: the
    # run is cut into a record a window
    assert len(spans) >= -(-min(out_cap, 15000) // (30 * (64 + 16)))


def test_decode_to_host_equals_reference(monkeypatch):
    """``decode_to_host`` (the CLI's route: no out_cap, each window's
    output appended on the host) on chains that cross many windows, a
    growing span included: the C decoder's bytes (multi-stream) and the
    reference's (single), the one-pass decode's at a cap past them."""
    windows = []
    for stream in _wide_chains():
        for multi in (False, True):
            want = _decoded(stream, multi)
            got, spans = _in_windows(
                monkeypatch, 256, 64, lambda: bitpar.decode_to_host(
                    torch.from_numpy(np.frombuffer(stream, np.uint8).copy()),
                    multi_stream=multi))
            assert got == want
            assert got == decode.decode_bytes(stream, 1 << 16,
                                              multi_stream=multi,
                                              device="cpu")
            windows.append(len(spans))
    assert max(windows) > 10


def long_token(offset: int, nibbles: int, term: int, lead: int = 0,
               history: int | None = None,
               tail: bytes = b"b") -> tuple[bytes, bytes]:
    """A raw stream that is one long copy, and the bytes it decodes to.

    ``history`` seeded literals (default ``offset``: the copy reads
    them), ``lead`` more (each moves the run's bit phase by one), a copy
    of ``offset`` (short form below 128) with length code 1111, then
    ``nibbles`` extension nibbles of 15 and ``term``, the literals of
    ``tail`` and an end marker. The token is 8 + 15 * nibbles + term
    bytes, each the byte ``offset`` back (zero before the stream's
    start): the bytes come from that rule, not from a decoder."""
    n = offset if history is None else history
    lits = np.random.default_rng(offset).integers(
        0, 256, n + lead, dtype=np.uint8).tobytes()
    w = ref.BitWriter()
    for c in lits:
        w.put(c, 9)
    if offset <= spec.SHORT_OFFSET_MAX:
        w.put(0b11 << 7 | offset, 9)
    else:
        w.put(0b10 << 11 | offset, 13)
    w.put(0b1111, 4)
    for _ in range(nibbles):
        w.put(spec.MAX_EXTENDED_LENGTH, 4)
    w.put(term, 4)
    for c in tail:
        w.put(c, 9)
    w.put(spec.END_MARKER_VALUE, spec.END_MARKER_BITS)
    w.pad_to_byte()
    src = (bytes(offset) + lits)[-offset:]
    size = 8 + 15 * nibbles + term
    want = lits + (src * (size // offset + 1))[:size] + tail
    return w.getvalue(), want


def _carried_steps(monkeypatch) -> list[int]:
    """Spy on ``bitpar._heads``: the bits from each continuation head (a
    run that an earlier window cut) to its successor, 4 per nibble."""
    steps = []
    heads = bitpar._heads

    def spy(comp, inbits, nbits, out_cap, multi_stream, carry=None):
        got = heads(comp, inbits, nbits, out_cap, multi_stream, carry)
        if carry is not None:
            at, off = carry
            step = got[0].gather(1, at[:, None].long())[:, 0]
            steps.extend(step[off >= 0].tolist())
        return got

    monkeypatch.setattr(bitpar, "_heads", spy)
    return steps


#: the long-token tests' windows: new bytes, margin, and output
#: expansion windows (``_ROW``; their plain expansion is the CPU's cost)
_LW, _LM, _LROW = 256, 64, 4096


def _host(monkeypatch, stream: bytes, multi: bool, win: int = _LW,
          margin: int = _LM):
    """``decode_to_host`` of ``stream`` in windows of ``win`` new bytes
    behind ``margin``, and its spans."""
    return _in_windows(monkeypatch, win, margin, lambda: bitpar.decode_to_host(
        torch.from_numpy(np.frombuffer(stream, np.uint8).copy()),
        multi_stream=multi), row=_LROW)


def _batch_windows(monkeypatch, buf, lens, out_cap, multi=False,
                   win=_LW, margin=_LM):
    """``decode_batch_bits`` of the batch in windows of ``win`` new bytes
    a row (the rows padded past ``_WIN``, so that the input windows
    run), and its spans."""
    b = len(lens)
    wide = np.pad(buf, ((0, 0), (0, max(win * b + 1 - buf.shape[1], 0))))
    return _in_windows(monkeypatch, win * b, margin,
                       lambda: _port(wide, lens, out_cap=out_cap,
                                     multi_stream=multi), row=_LROW)


@pytest.mark.parametrize("windows", [1, 2, 5])
@pytest.mark.parametrize("offset", [1, 7, 127, 128, 2047])
def test_long_token_decodes(monkeypatch, offset, windows):
    """A copy whose run of 15-nibbles spans 1, 2 or 5 input windows (256
    new bytes behind 64 of margin), short and long offset forms, at
    every bit phase of the run (0-7 leading literals) and terminators 0,
    3 and 14: ``decode_to_host`` gives the C decoder's, the reference's
    and the copy rule's bytes, one record a window, no span wider than
    ``_WIN + _MARGIN``; ``decode_batch_bits`` over the 24 rows, in
    windows, equals the one-pass decode bitwise at out_caps inside every
    token, at the end of one and past every output."""
    nibbles = 2 * windows * _LW - 37
    steps = _carried_steps(monkeypatch)
    streams, wants = [], []
    for term in (0, 3, 14):
        for lead in range(8):
            stream, want = long_token(offset, nibbles, term, lead)
            assert ref.lzs_decompress(stream) == want
            assert native.decompress(stream, out_cap=len(want) + 64,
                                     multi_stream=True) == want
            got, spans = _host(monkeypatch, stream, bool(lead & 1))
            assert got == want
            assert max(spans) <= _LW + _LM
            assert len(spans) > len(stream) // (_LW + _LM)
            streams.append(stream)
            wants.append(want)
    # a run of w windows is cut w - 1 times or more
    assert len(steps) >= len(streams) * (windows - 1)
    buf, lens = _batch(streams)
    for out_cap in (offset + 8 + 15 * nibbles // 2, len(wants[0]) - 1,
                    max(map(len, wants)) + 64):
        want = _port(buf, lens, out_cap=out_cap)
        got, spans = _batch_windows(monkeypatch, buf, lens, out_cap)
        _assert_equal(got, want)
        assert max(spans) <= _LW * len(lens) + _LM
        for i, w in enumerate(wants):
            assert got[0][i, :got[1][i]].tobytes() == w[:out_cap]


@pytest.mark.parametrize("lead", [0, 1, 2, 3])
def test_long_token_every_truncation(monkeypatch, lead):
    """A run cut by the input's end at every byte across two window
    boundaries (64 new bytes behind 16 of margin), its end 0-3 bits into
    a nibble (``lead`` moves the run's phase): the one-pass semantics,
    len_init plus the run's whole nibbles, then the chain ends.
    ``decode_to_host`` (multi-stream on odd cuts) gives the C decoder's
    bytes and the one-pass decode's; ``decode_batch_bits`` of every cut,
    in windows, equals the one-pass decode bitwise."""
    stream, _ = long_token(7, 2 * 4 * 64, 3, lead)
    cuts = list(range(56, 150))
    rows = [stream[:n] for n in cuts]
    buf, lens = _batch(rows)
    for out_cap in (1000, 1 << 16):
        want = _port(buf, lens, out_cap=out_cap)
        got, spans = _batch_windows(monkeypatch, buf, lens, out_cap,
                                    win=64, margin=16)
        _assert_equal(got, want)
        assert max(spans) <= 64 * len(rows) + 16
    for i, row in enumerate(rows):
        multi = bool(cuts[i] & 1)
        got, spans = _host(monkeypatch, row, multi, 64, 16)
        assert got == native.decompress(row, out_cap=1 << 16,
                                        multi_stream=multi)
        assert got == want[0][i, :want[1][i]].tobytes()
        assert max(spans) <= 64 + 16


@pytest.mark.parametrize("multi", [False, True])
def test_long_tokens_in_a_batch_equal_one_pass(monkeypatch, rows37, multi):
    """The batch of 37 rows and two long-token rows (runs over some 6
    and 4 windows of 64 new bytes: 512 over 39 rows behind 64 of margin,
    so both are cut while the other rows decode): bitwise the one-pass
    decode (bytes, lengths, end markers) at out_caps inside a window's
    output and past 2^18; each row's bytes are the JAX package's
    decoders' (in multi-stream mode, the second token's row goes on
    from the byte after its end marker into another stream)."""
    streams = rows37[2] + [long_token(2047, 2 * 3 * _LW, 14, 5)[0],
                           long_token(1, 2 * 2 * _LW, 0, 2)[0]
                           + native.compress(b"the next stream")]
    buf, lens = _batch(streams)
    assert len(lens) >= 33
    for out_cap in (2305, bitpar.MAX_OUT_CAP + 4096):
        want = _port(buf, lens, out_cap=out_cap, multi_stream=multi)
        got, spans = _in_windows(
            monkeypatch, 512, 64,
            lambda: _port(buf, lens, out_cap=out_cap, multi_stream=multi))
        _assert_equal(got, want)
        assert max(spans) <= 512 + 64
    for i, st in enumerate(streams):
        assert got[0][i, :got[1][i]].tobytes() == _decoded(st, multi)


@pytest.mark.parametrize("offset", [1, 2047])
def test_long_token_tiny_margin(monkeypatch, offset):
    """Slot compaction: ``_slots`` keeps one head per 9 bits, so a cut
    leaves its continuation three 15-nibbles or more before its end (the
    successor 16 bits on). With ``_MARGIN`` at its least, 8 bytes, and 1
    new byte a window, a long-offset head (17 bits) at bit 4-7 of its
    byte whose run holds four 15-nibbles is cut with exactly three left:
    at every bit phase and runs of 4, 5 and 60 nibbles (16 literals
    after the token, so that the row goes on past the span),
    ``decode_to_host`` and ``decode_batch_bits`` give the copy rule's
    bytes, and no continuation steps less than 16 bits (16 itself
    occurs)."""
    steps = _carried_steps(monkeypatch)
    streams, wants = [], []
    for nibbles in (4, 5, 60):
        for lead in range(8):
            stream, want = long_token(offset, nibbles, 3, lead, history=0,
                                      tail=b"tail after token")
            assert native.decompress(stream, out_cap=4096) == want
            got, spans = _host(monkeypatch, stream, False, 1, 8)
            assert got == want
            assert max(spans) <= 1 + 8
            streams.append(stream)
            wants.append(want)
    buf, lens = _batch(streams)
    got, spans = _batch_windows(monkeypatch, buf, lens, 4096, win=1,
                                margin=8)
    _assert_equal(got, _port(buf, lens, out_cap=4096))
    for i, w in enumerate(wants):
        assert got[0][i, :got[1][i]].tobytes() == w
    # the tight case: three 15-nibbles and the end nibble (a short-offset
    # head, 13 bits, leaves four)
    assert min(steps) == (16 if offset > spec.SHORT_OFFSET_MAX else 20)
