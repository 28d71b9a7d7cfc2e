"""lzs_tpu_torch: the streaming codec and the host model vs JAX.

* The port's ``stream`` through the counterparts of all 17 tests of
  ``tests/test_stream.py``, its match search on the CPU (``device="cpu"``);
  ``compress_stream`` over both engines: "python" (the default: the
  class, whose match search is the port's torch search, on the card
  unless a device is named) and "auto" (the native C++ encoder on the
  host, the port's ``utils.native``). A stream's bytes equal
  ``reference.lzs_compress`` of the concatenated feeds and its decode
  gives the input back.
* A JAX stream checkpoint resumes in the port
  (``convert.stream_state_from_jax``) with the one-shot bytes.
* The port's ``reference``, ``utils.native`` and ``utils.debug`` against
  the JAX package's copies, and the counterparts of
  ``test_reference_model.py``, ``test_native.py`` and
  ``test_utils_profiles.py``'s three ``debug`` tests.
"""

import io
import json
import random

import numpy as np
import pytest
import torch

from lzs_tpu import reference as jref
from lzs_tpu import stream as jstream
from lzs_tpu.utils import debug as jdebug
from lzs_tpu.utils import native as jnative
from lzs_tpu_torch import convert, reference, spec, stream, trace
from lzs_tpu_torch.utils import debug, native

from golden import (GOLDEN_COMPRESSED, GOLDEN_PLAINTEXT,
                    repeated_byte_expected_size, uncompressible_sequence)
from test_stream import mixed_data

CPU = "cpu"
DATA = mixed_data(5, 20000)
ONE_SHOT = reference.lzs_compress(DATA)
SMALL = mixed_data(6, 1500)
SMALL_ONE_SHOT = reference.lzs_compress(SMALL)
ENGINES = ["auto", "python"]


def compressor(**kw) -> stream.StreamCompressor:
    return stream.StreamCompressor(device=CPU, **kw)


def compress(data: bytes, feed: int, engine: str) -> bytes:
    """compress_stream on the CPU: the class's match search on ``CPU``;
    the native engine runs on the host and takes no device."""
    kw = {"device": CPU} if engine == "python" else {}
    return stream.compress_stream(data, feed, engine=engine, **kw)


# --- counterparts of tests/test_stream.py -------------------------------

@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("feed", [555, 4096, 50000])
def test_stream_compress_matches_one_shot(feed, engine):
    assert compress(DATA, feed, engine) == ONE_SHOT


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("feed", [1, 7, 64])
def test_stream_compress_tiny_feeds(feed, engine):
    assert compress(SMALL, feed, engine) == SMALL_ONE_SHOT


def test_stream_compress_status_protocol():
    c = compressor()
    assert c.status & stream.INPUT_STARVED
    c.feed(DATA[:100])
    out = c.finish()
    assert out
    assert c.status & stream.FINISHED
    assert c.status & stream.END_MARKER
    with pytest.raises(ValueError):
        c.feed(b"x")


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("feed", [1, 3, 10, 997, 10**9])
def test_stream_decompress_chunked(feed, engine):
    assert stream.decompress_stream(ONE_SHOT, feed, engine=engine) == DATA


@pytest.mark.parametrize("max_out", [1, 10, 333])
def test_stream_decompress_output_bounded(max_out):
    d = stream.StreamDecompressor()
    out = bytearray()
    out += d.feed(ONE_SHOT, max_out=max_out)
    while True:
        piece = d.feed(b"", max_out=max_out)
        if not piece:
            break
        out += piece
    assert bytes(out) == DATA


def test_stream_decompress_concatenated_streams():
    a, b = DATA[:5000], DATA[5000:9000]
    blob = reference.lzs_compress(a) + reference.lzs_compress(b)
    d = stream.StreamDecompressor()
    out = d.feed(blob)
    assert out == a + b
    assert d.markers == 2
    d2 = stream.StreamDecompressor(stop_at_end=True)
    assert d2.feed(blob) == a
    assert d2.status & stream.FINISHED
    assert stream.decompress_stream(blob, 1000) == a + b
    assert stream.decompress_stream(blob, 1000, stop_at_end=True) == a


def test_checkpoint_resume_compressor():
    c = compressor()
    out = bytearray(c.feed(DATA[:9000]))
    snap = c.state_dict()
    assert snap["device"] == CPU
    c2 = stream.StreamCompressor.from_state_dict(snap)
    out2 = bytearray(out)
    out += c.feed(DATA[9000:])
    out += c.finish()
    out2 += c2.feed(DATA[9000:])
    out2 += c2.finish()
    assert bytes(out) == bytes(out2) == ONE_SHOT


def test_checkpoint_resume_decompressor():
    d = stream.StreamDecompressor()
    out = bytearray(d.feed(ONE_SHOT[:1000]))
    d2 = stream.StreamDecompressor.from_state_dict(d.state_dict())
    rest = d.feed(ONE_SHOT[1000:])
    rest2 = d2.feed(ONE_SHOT[1000:])
    assert rest == rest2
    assert bytes(out) + rest == DATA


@pytest.mark.parametrize("cap", [1, 64, 512])
def test_stream_compress_output_bounded_drive_loop(cap):
    """The reference CLI's drive loop (utils/lzs-compress.c:91-134): a
    fixed-size output buffer, finish after the input, loop until
    FINISHED."""
    c = compressor()
    out = bytearray()
    feeds = [DATA[i:i + 512] for i in range(0, len(DATA), 512)]
    for piece in feeds:
        out += c.feed(piece, max_out=cap)
        while c.status & stream.OUTPUT_FULL:
            out += c.feed(b"", max_out=cap)
    while not (c.status & stream.FINISHED):
        out += c.feed(b"", finish=True, max_out=cap)
    assert bytes(out) == ONE_SHOT
    assert c.status & stream.END_MARKER


def test_stream_compress_error_status():
    c = compressor(bit_n=99, bit_acc=1 << 62)
    assert c.feed(b"abc") == b""
    assert c.status & stream.ERROR


def test_stream_decompress_error_status():
    d = stream.StreamDecompressor(mode=7)
    assert d.feed(ONE_SHOT) == b""
    assert d.status & stream.ERROR
    d2 = stream.StreamDecompressor(cur_off=9999)
    d2.feed(ONE_SHOT)
    assert d2.status & stream.ERROR


def test_stream_decompress_large_feed_tiny_budget_linear():
    """Unread input stays bytes, not a bignum bit queue (which would make
    draining quadratic). The 1 MiB stream comes from the native encoder,
    whose bytes are the reference model's (test_native_compress_*)."""
    big = mixed_data(9, 1 << 20)
    comp = native.compress(big)
    d = stream.StreamDecompressor()
    first = d.feed(comp, max_out=1)
    assert len(first) == 1
    assert isinstance(d.in_pending, bytes)
    assert d.bit_n <= 32
    out = bytearray(first)
    while True:
        piece = d.feed(b"", max_out=1 << 16)
        if not piece:
            break
        out += piece
    assert bytes(out) == big


def test_zero_fill_out_of_range_offset():
    w = reference.BitWriter()
    w.put(1, 1)
    w.put(1, 1)
    w.put(5, 7)      # offset 5 with empty history
    w.put(0b00, 2)   # length 2
    w.put(0b110000000, 9)
    w.pad_to_byte()
    d = stream.StreamDecompressor()
    assert d.feed(w.getvalue()) == b"\x00\x00"


def test_cross_reference_c_streamed(ref_driver):
    comp = stream.compress_stream(DATA[:6000], 777, engine="python",
                                  device=CPU)
    assert ref_driver("d", comp) == DATA[:6000]
    c_comp = ref_driver("c", DATA[:6000])
    assert stream.decompress_stream(c_comp, 101) == DATA[:6000]


def test_native_encoder_bytes_streamed():
    """The C encoder's bytes (the port's native binding) and the stream's
    agree, and each decodes the other's (the reference tree's driver
    above is not always there)."""
    comp = stream.compress_stream(DATA[:6000], 777, engine="python",
                                  device=CPU)
    assert comp == native.compress(DATA[:6000])
    assert native.decompress(comp, out_cap=6016) == DATA[:6000]


@pytest.mark.parametrize("engine", ENGINES)
def test_large_feed_slicing_matches_one_shot(engine):
    """Feeds past the 32768-position search span slice internally and
    keep the one-shot bytes, with runs alive across slice boundaries
    carried as extension state."""
    rng = np.random.default_rng(11)
    cases = [
        bytes(rng.integers(0, 256, 70000, dtype=np.uint8)),
        b"R" * 70000,
        (b"lorem ipsum dolor " * 5000)[:70000],
    ]
    for data in cases:
        one = native.compress(data)
        for fs in (70000, 65536, 33000):
            assert compress(data, fs, engine) == one
    # the native encoder's bytes are the reference model's
    assert one == reference.lzs_compress(cases[2])


def test_extension_state_checkpoint_mid_run():
    data = b"A" * 200 + b"B" * 50000 + b"A" * 200
    one = native.compress(data)
    c = compressor()
    out = c.feed(data[:30000])
    assert c.ext_off or c.pending
    c2 = stream.StreamCompressor.from_state_dict(c.state_dict())
    out += c2.feed(data[30000:])
    out += c2.finish()
    assert out == one


def test_stream_exhaustive_backend():
    """backend="exhaustive" (the brute-force plane of ops.match, the
    counterpart of lzs_simple_compress_incremental) streams the one-shot
    bytes, and so does a feed loop that crosses a 32768-position slice."""
    sc = compressor(backend="exhaustive")
    out = bytearray()
    for i in range(0, len(SMALL), 277):
        out += sc.feed(SMALL[i:i + 277])
    out += sc.feed(finish=True)
    assert bytes(out) == SMALL_ONE_SHOT
    sc = compressor(backend="exhaustive")
    data = mixed_data(8, 40000)
    out = sc.feed(data[:35000]) + sc.feed(data[35000:]) + sc.finish()
    assert out == native.compress(data)


def test_stream_match_is_a_stage():
    """Each slice's match search runs in the ``stream_match`` span (the
    sort backend's own stages inside it)."""
    assert trace.STREAM_STAGES == ("stream_match",)
    assert not set(trace.STREAM_STAGES) & set(trace.STAGES)
    with trace.stage_times() as times:
        c = compressor()
        out = c.feed(DATA[:5000]) + c.finish()
    assert out == reference.lzs_compress(DATA[:5000])
    assert {"stream_match", "candidates", "extend"} <= set(times)
    assert times["stream_match"] >= times["candidates"]


# --- JAX checkpoints resume in the port ---------------------------------

def test_jax_checkpoint_resumes_in_port_mid_run():
    data = b"A" * 200 + b"B" * 50000 + b"A" * 200
    one = native.compress(data)
    c = jstream.StreamCompressor()
    out = c.feed(data[:30000])
    state = c.state_dict()
    assert state["ext_off"] or state["pending"]
    port = convert.stream_state_from_jax(state, device=CPU)
    assert isinstance(port, stream.StreamCompressor)
    assert port.device == CPU
    out += port.feed(data[30000:])
    out += port.finish()
    assert out == one


def test_jax_checkpoint_resumes_in_port_after_feeds():
    c = jstream.StreamCompressor()
    out = bytearray()
    for i in range(0, 9100, 700):
        out += c.feed(DATA[i:i + 700])
    port = convert.stream_state_from_jax(c.state_dict(), device=CPU)
    out += port.feed(DATA[9100:]) + port.finish()
    assert bytes(out) == ONE_SHOT
    # a JAX state carries no device key and loads onto the card
    assert stream.StreamCompressor.from_state_dict(
        c.state_dict()).device == "cuda"


def test_jax_decompressor_checkpoint_resumes_in_port():
    d = jstream.StreamDecompressor()
    out = bytearray(d.feed(ONE_SHOT[:1000], max_out=700))
    port = convert.stream_state_from_jax(d.state_dict())
    assert isinstance(port, stream.StreamDecompressor)
    out += port.feed(ONE_SHOT[1000:])
    assert bytes(out) == DATA


def test_stream_state_from_jax_rejects_other_states():
    state = jstream.StreamCompressor().state_dict()
    with pytest.raises(KeyError):
        convert.stream_state_from_jax({**state, "extra": 1})
    with pytest.raises(KeyError):
        convert.stream_state_from_jax({**state, "device": "cpu"})
    del state["backend"]
    with pytest.raises(KeyError):
        convert.stream_state_from_jax(state)


def test_port_state_is_jax_state_plus_device():
    port = compressor()
    port.feed(DATA[:3000])
    jax_c = jstream.StreamCompressor()
    jax_c.feed(DATA[:3000])
    mine, theirs = port.state_dict(), jax_c.state_dict()
    assert mine.pop("device") == CPU
    assert mine == theirs
    json.dumps({k: v for k, v in mine.items() if not isinstance(v, bytes)})


# --- the native engine raises, it does not fall back --------------------

def test_auto_engine_raises_when_native_fails(monkeypatch):
    def broken():
        raise RuntimeError("building liblzs_native.so failed")

    monkeypatch.setattr(native, "load", broken)
    with pytest.raises(RuntimeError):
        stream.compress_stream(SMALL, engine="auto")
    with pytest.raises(RuntimeError):
        stream.decompress_stream(SMALL_ONE_SHOT, engine="auto")
    # the Python class does not need the native runtime
    assert stream.compress_stream(SMALL, engine="python",
                                  device=CPU) == SMALL_ONE_SHOT


def test_compress_stream_defaults_to_the_class_on_the_card(monkeypatch):
    """With no engine and no device, compress_stream runs the class with
    its match search on "cuda"; the native engine refuses a device."""
    made = []

    class Recorder(stream.StreamCompressor):
        def __init__(self, **kw):
            made.append(kw["device"])
            super().__init__(**{**kw, "device": CPU})

    monkeypatch.setattr(stream, "StreamCompressor", Recorder)
    assert stream.compress_stream(SMALL) == SMALL_ONE_SHOT
    assert made == ["cuda"]
    with pytest.raises(ValueError):
        stream.compress_stream(SMALL, engine="auto", device=CPU)


def test_unknown_engine_raises():
    with pytest.raises(ValueError):
        stream.compress_stream(SMALL, engine="jax")
    with pytest.raises(ValueError):
        stream.decompress_stream(SMALL_ONE_SHOT, engine="jax")


def test_stream_flags_equal_jax():
    for k in ("INPUT_STARVED", "OUTPUT_FULL", "FINISHED", "END_MARKER",
              "ERROR"):
        assert getattr(stream, k) == getattr(jstream, k)
    for k in ("INPUT_STARVED", "OUTPUT_FULL", "FINISHED", "END_MARKER"):
        assert getattr(native, k) == getattr(jnative, k)


def test_package_exports_stream_and_reference():
    import lzs_tpu_torch

    assert lzs_tpu_torch.StreamCompressor is stream.StreamCompressor
    assert lzs_tpu_torch.StreamDecompressor is stream.StreamDecompressor
    assert lzs_tpu_torch.lzs_compress is reference.lzs_compress
    assert lzs_tpu_torch.lzs_decompress is reference.lzs_decompress
    from lzs_tpu_torch import coders

    assert lzs_tpu_torch.GeneralCodec is coders.GeneralCodec
    with pytest.raises(AttributeError):
        lzs_tpu_torch.NotAName


# --- the host model: reference.py against JAX's copy --------------------

def _mixtures(seed: int, count: int):
    rng = random.Random(seed)
    for _ in range(count):
        parts = []
        for _ in range(rng.randrange(1, 30)):
            kind = rng.randrange(3)
            if kind == 0:
                parts.append(bytes(rng.randrange(256)
                                   for _ in range(rng.randrange(1, 60))))
            elif kind == 1:
                parts.append(bytes([rng.randrange(256)])
                             * rng.randrange(1, 80))
            else:
                parts.append(b"the quick brown fox " * rng.randrange(1, 5))
        yield b"".join(parts)


def test_reference_equals_jax_module():
    for data in list(_mixtures(8, 6)) + [b"", GOLDEN_PLAINTEXT,
                                          DATA[:3000]]:
        tokens = reference.compress(data)
        assert tokens == jref.compress(data)
        comp = reference.encode(tokens)
        assert comp == jref.encode(tokens) == reference.lzs_compress(data)
        assert reference.decode(comp) == jref.decode(comp)
        assert reference.decompress(tokens) == jref.decompress(tokens)
        for stop in (True, False):
            assert (reference.lzs_decompress(comp + comp, stop_at_end=stop)
                    == jref.lzs_decompress(comp + comp, stop_at_end=stop))


def test_golden_decode():
    assert reference.lzs_decompress(GOLDEN_COMPRESSED) == GOLDEN_PLAINTEXT


def test_golden_encode():
    assert reference.lzs_compress(GOLDEN_PLAINTEXT) == GOLDEN_COMPRESSED


@pytest.mark.parametrize("n", list(range(0, 64)) + [100, 255, 506])
def test_uncompressible_prefixes(n):
    data = uncompressible_sequence()[:n]
    comp = reference.lzs_compress(data)
    assert len(comp) == (n * 9 + spec.END_MARKER_BITS + 7) // 8
    assert reference.lzs_decompress(comp) == data


@pytest.mark.parametrize("n", list(range(0, 40)) + [100, 128, 500, 1000])
def test_repeated_byte_sizes(n):
    data = b"X" * n
    comp = reference.lzs_compress(data)
    assert len(comp) == repeated_byte_expected_size(n)
    assert reference.lzs_decompress(comp) == data


def test_roundtrip_random_mixtures():
    for data in _mixtures(42, 8):
        assert reference.lzs_decompress(reference.lzs_compress(data)) == data


def test_long_range_matches_cross_window():
    base = bytes(range(256)) * 8
    data = base[:100] + bytes(2047 - 100) + base[:100]
    assert reference.lzs_decompress(reference.lzs_compress(data)) == data


def test_zero_fill_on_corrupt_offset():
    w = reference.BitWriter()
    w.put(1, 1)
    w.put(1, 1)
    w.put(5, 7)
    w.put(0b01, 2)
    w.put(spec.END_MARKER_VALUE, spec.END_MARKER_BITS)
    w.pad_to_byte()
    assert reference.lzs_decompress(w.getvalue()) == b"\x00\x00\x00"


def test_multi_stream_concatenation():
    a, b = b"hello hello hello", b"world world world"
    blob = reference.lzs_compress(a) + reference.lzs_compress(b)
    assert reference.lzs_decompress(blob, stop_at_end=False) == a + b
    assert reference.lzs_decompress(blob, stop_at_end=True) == a


def test_compressed_max_bound():
    rng = random.Random(7)
    data = bytes(rng.randrange(256) for _ in range(4096))
    assert len(reference.lzs_compress(data)) <= spec.compressed_max(len(data))


@pytest.mark.parametrize("name,data", [
    ("text", (GOLDEN_PLAINTEXT * 10)[:4000]),
    ("repeats", b"ab" * 1000 + b"xyz" * 300),
    ("binary", bytes((i * 7 + (i >> 3)) % 256 for i in range(3000))),
])
def test_cross_reference_c(ref_driver, name, data):
    c_stream = ref_driver("c", data)
    assert reference.lzs_compress(data) == c_stream
    assert reference.lzs_decompress(c_stream) == data
    assert ref_driver("d", reference.lzs_compress(data)) == data


# --- the native runtime: utils/native.py against JAX's ------------------

NATIVE_CASES = [
    b"",
    b"Q",
    b"XX",
    b"XXX",
    GOLDEN_PLAINTEXT,
    uncompressible_sequence(),
    b"A" * 5000,
    b"ab" * 3000,
    (GOLDEN_PLAINTEXT * 30)[:12000],
]


def test_native_builds_apart_from_jax():
    assert native._SO != jnative._SO
    assert native._SO.parent.name == "native"
    assert native._SO.parent.parent.name == "build"


@pytest.mark.parametrize("data", NATIVE_CASES, ids=range(len(NATIVE_CASES)))
def test_native_compress_matches_oracle_and_jax(data):
    comp = native.compress(data)
    assert comp == reference.lzs_compress(data)
    assert comp == jnative.compress(data)


def test_native_golden():
    assert native.compress(GOLDEN_PLAINTEXT) == GOLDEN_COMPRESSED
    assert native.decompress(GOLDEN_COMPRESSED) == GOLDEN_PLAINTEXT


@pytest.mark.parametrize("data", NATIVE_CASES, ids=range(len(NATIVE_CASES)))
def test_native_decompress_roundtrip(data):
    assert native.decompress(native.compress(data),
                             out_cap=len(data) + 16) == data


def test_native_fuzz_vs_oracle():
    rng = random.Random(77)
    for _ in range(12):
        parts = []
        for _ in range(rng.randrange(1, 30)):
            k = rng.randrange(3)
            if k == 0:
                parts.append(bytes(rng.randrange(256)
                                   for _ in range(rng.randrange(1, 80))))
            elif k == 1:
                parts.append(bytes([rng.randrange(256)])
                             * rng.randrange(1, 200))
            else:
                parts.append(b"abcabcabd" * rng.randrange(1, 10))
        data = b"".join(parts)
        assert native.compress(data) == reference.lzs_compress(data)
        assert native.decompress(reference.lzs_compress(data),
                                 out_cap=len(data) + 16) == data


def test_native_emit_from_match_tables():
    """The hybrid stage: a stream packed from the port's device match
    tables (the torch search on the CPU) is the reference's."""
    data = (GOLDEN_PLAINTEXT * 4)[:1500]
    arr = np.frombuffer(data, np.uint8).astype(np.int32)
    score, off, _ = stream._best_matches_host(arr, len(data), device=CPU)
    assert native.emit(data, score[:len(data)], off[:len(data)]) == \
        reference.lzs_compress(data)


def test_native_stream_encoder_chunked_matches_single_call():
    rng = random.Random(3)
    data = (GOLDEN_PLAINTEXT * 20 + b"Z" * 4000
            + bytes(rng.randrange(256) for _ in range(3000)))
    expect = reference.lzs_compress(data)
    for chunk in (1, 7, 64, 512, 4096):
        enc = native.StreamEncoder()
        out = bytearray()
        for s in range(0, len(data), chunk):
            piece, st = enc.feed(data[s:s + chunk])
            out += piece
        piece, st = enc.feed(b"", finish=True)
        out += piece
        assert st & native.FINISHED
        enc.close()
        assert bytes(out) == expect, f"chunk={chunk}"


def test_native_stream_encoder_empty_input():
    enc = native.StreamEncoder()
    out, _ = enc.feed(b"", finish=True)
    assert out == reference.lzs_compress(b"")
    enc.close()


def test_native_stream_decoder_chunked():
    data = (GOLDEN_PLAINTEXT * 10) + b"R" * 2000
    comp = reference.lzs_compress(data)
    for chunk in (1, 3, 17, 100, 1000):
        dec = native.StreamDecoder()
        out = bytearray()
        for s in range(0, len(comp), chunk):
            piece, _ = dec.feed(comp[s:s + chunk])
            out += piece
        assert bytes(out) == data, f"chunk={chunk}"
        assert dec.markers == 1
        dec.close()


def test_native_stream_decoder_output_bounded():
    data = b"N" * 500 + GOLDEN_PLAINTEXT[:200]
    comp = reference.lzs_compress(data)
    dec = native.StreamDecoder()
    out = bytearray()
    pos = 0
    for _ in range(10000):
        piece, st = dec.feed(comp[pos:pos + 5], out_cap=10)
        pos = min(pos + 5, len(comp))
        out += piece
        while st & native.OUTPUT_FULL:
            piece, st = dec.feed(b"", out_cap=10)
            out += piece
        if pos >= len(comp) and not piece and (st & native.INPUT_STARVED):
            break
    assert bytes(out) == data


def test_native_stream_decoder_concatenated_streams():
    a, b = b"first part " * 10, b"second part " * 12
    comp = reference.lzs_compress(a) + reference.lzs_compress(b)
    dec = native.StreamDecoder()
    out, _ = dec.feed(comp, out_cap=4096)
    assert out == a + b
    assert dec.markers == 2
    dec.close()


def test_native_cross_reference_c(ref_driver):
    data = (GOLDEN_PLAINTEXT + b"#" * 300) * 3
    assert native.compress(data) == ref_driver("c", data)
    assert ref_driver("d", native.compress(data)) == data


# --- utils/debug.py against JAX's ---------------------------------------

DEBUG_DATA = (b"observability " * 300)[:3000]
BLOB = reference.lzs_compress(DEBUG_DATA)


def test_dump_tokens():
    buf = io.StringIO()
    n = debug.dump_tokens(BLOB, out=buf)
    text = buf.getvalue()
    assert n > 0
    assert "end marker" in text
    assert "match offset=" in text
    jbuf = io.StringIO()
    assert jdebug.dump_tokens(BLOB, out=jbuf) == n
    assert jbuf.getvalue() == text


def test_stream_stats():
    s = debug.stream_stats(BLOB)
    assert s.out_bytes == len(DEBUG_DATA)
    assert s.comp_bytes == len(BLOB)
    assert s.markers == 1
    assert s.matches > 0
    assert 0 < s.ratio < 1
    j = jdebug.stream_stats(BLOB)
    assert (s.tokens, s.literals, s.matches, s.markers, s.match_bytes,
            s.out_bytes, s.comp_bytes, s.max_length, s.max_offset) == (
        j.tokens, j.literals, j.matches, j.markers, j.match_bytes,
        j.out_bytes, j.comp_bytes, j.max_length, j.max_offset)


def test_meter():
    m = debug.Meter()
    m.record_encode(1000, 300, 0.001)
    m.record_decode(1000, 0.0005)
    r = m.report()
    assert r["ratio"] == 0.3
    assert r["encode_GBps"] > 0
    j = jdebug.Meter()
    j.record_encode(1000, 300, 0.001)
    j.record_decode(1000, 0.0005)
    assert r == j.report()


def test_timed_prints_label():
    buf = io.StringIO()
    with debug.timed("stream", out=buf):
        pass
    assert buf.getvalue().startswith("stream: ")


def test_device_trace_writes_chrome_trace(tmp_path):
    with debug.device_trace(str(tmp_path / "t")) as prof:
        torch.ones(64).cumsum(0)
    assert prof is not None
    trace = json.loads((tmp_path / "t" / "trace.json").read_text())
    assert trace["traceEvents"]
