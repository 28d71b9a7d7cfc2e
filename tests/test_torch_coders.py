"""lzs_tpu_torch: the generalized coders and codec profiles vs JAX.

* Counterparts of ``tests/test_coders_cli.py``'s five coder tests (its
  60 (offset coder, length preset) cases included: the port's bytes equal
  the JAX package's) and ``tests/test_utils_profiles.py``'s two profile
  tests, with the match search on the CPU (``device="cpu"``).
* The match tables behind those cases: only five (window, cap) pairs
  occur, so a module fixture searches each once in both packages; the
  tables are compared bitwise, and the 60 cases run their coders on the
  cached tables.
* Offsets past 2047 (profiles ``reach``, ``flat``, ``bounded``): a block
  of random bytes repeated, so that every later position matches at the
  period; the port's tokens equal JAX's and round-trip.
* The coder's limits and names: ValueError past 32768 bytes, JAX's
  KeyError text for an unknown profile, the card as the default device,
  ``convert.general_codec_from_jax`` on every profile.
"""

import dataclasses

import numpy as np
import pytest

import lzs_tpu_torch
from lzs_tpu import coders as jcoders
from lzs_tpu import reference as jref
from lzs_tpu import stream as jstream
from lzs_tpu.models import PROFILES as JPROFILES
from lzs_tpu.models import get_profile as jget_profile
from lzs_tpu_torch import coders, convert, stream
from lzs_tpu_torch.models import PROFILES, get_profile

from golden import GOLDEN_COMPRESSED, GOLDEN_PLAINTEXT
from test_stream import mixed_data

CPU = "cpu"
DATA = mixed_data(9, 8000)
PIECE = DATA[:4000]
OBSERVE = (b"observability " * 300)[:3000]   # test_utils_profiles's DATA
OFFSET_CODERS = [(7, 11), (6, 10), "biased", 12, 9]


def on_cpu(codec):
    return dataclasses.replace(codec, device=CPU)


def offset_coder(mod, spec_):
    """test_coders_cli's offset coder ``spec_`` from module ``mod``."""
    if spec_ == "biased":
        return mod.BiasedOffsetCoder(7, 11)
    if isinstance(spec_, tuple):
        return mod.StandardOffsetCoder(*spec_)
    return mod.FixedOffsetCoder(spec_)


def repeat_block(period: int, seed: int = 0) -> bytes:
    """``period`` random bytes, twice: from ``period`` on every position
    matches at offset ``period``."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, period, dtype=np.uint8).tobytes() * 2


def test_standard_codec_wire_compatible():
    codec = on_cpu(coders.STANDARD_CODEC)
    blob = codec.compress_bytes(DATA)
    assert blob == jref.lzs_compress(DATA)
    assert codec.decompress_bytes(blob) == DATA


def test_standard_codec_golden_vector():
    codec = on_cpu(coders.STANDARD_CODEC)
    assert codec.decompress_bytes(GOLDEN_COMPRESSED) == GOLDEN_PLAINTEXT


def _pairs():
    """The (window, cap) pairs of the 60 cases (five)."""
    return sorted({(c.window, c.search_cap) for c in (
        coders.GeneralCodec(offset_coder(coders, o),
                            coders.LENGTH_CODER_PRESETS[k])
        for o in OFFSET_CODERS for k in coders.LENGTH_CODER_PRESETS)})


@pytest.fixture(scope="module")
def tables():
    """Each pair's match table over PIECE, searched once by the port (on
    the CPU) and once by JAX: {(window, cap): (port, jax)}."""
    arr = np.frombuffer(PIECE, np.uint8).astype(np.int32)
    return {(w, c): (stream._best_matches_host(arr, len(PIECE), window=w,
                                               cap=c, device=CPU),
                     jstream._best_matches_host(arr, len(PIECE), window=w,
                                                cap=c))
            for w, c in _pairs()}


def test_case_pairs_are_the_five_windows():
    assert _pairs() == [(511, 12), (1023, 12), (2047, 12), (2174, 12),
                        (4095, 12)]


@pytest.mark.parametrize("pair", _pairs())
def test_match_tables_equal_jax(tables, pair):
    port, jax_ = tables[pair]
    for got, want in zip(port, jax_, strict=True):
        np.testing.assert_array_equal(got, np.asarray(want))


def _cached(tables, which: int):
    """A ``_best_matches_host`` that returns the cached tables of PIECE."""
    def search(arr, n, window, cap, **kw):
        assert n == len(PIECE)
        return tables[(window, cap)][which]
    return search


@pytest.mark.parametrize("offc", OFFSET_CODERS)
@pytest.mark.parametrize("lenc", sorted(coders.LENGTH_CODER_PRESETS))
def test_general_profiles_roundtrip(tables, monkeypatch, offc, lenc):
    monkeypatch.setattr(stream, "_best_matches_host", _cached(tables, 0))
    monkeypatch.setattr(jstream, "_best_matches_host", _cached(tables, 1))
    codec = coders.GeneralCodec(offset_coder(coders, offc),
                                coders.LENGTH_CODER_PRESETS[lenc],
                                device=CPU)
    jcodec = jcoders.GeneralCodec(offset_coder(jcoders, offc),
                                  jcoders.LENGTH_CODER_PRESETS[lenc])
    blob = codec.compress_bytes(PIECE)
    assert blob == jcodec.compress_bytes(PIECE)
    assert codec.decompress_bytes(blob) == PIECE


def test_token_stages_compose():
    codec = on_cpu(coders.STANDARD_CODEC)
    toks = codec.compress(DATA[:2000])
    blob = codec.encode(toks)
    toks2 = codec.decode(blob)
    assert toks == toks2
    assert codec.decompress(toks2) == DATA[:2000]


def test_gen_decompress_bounded_memory():
    codec = on_cpu(coders.STANDARD_CODEC)
    toks = codec.compress(DATA[:3000])
    pieces = list(codec.gen_decompress(toks))
    assert b"".join(pieces) == DATA[:3000]


@pytest.mark.parametrize("name", sorted(JPROFILES))
def test_profiles_roundtrip(name):
    codec = get_profile(name, device=CPU)
    blob = codec.compress_bytes(OBSERVE[:1200])
    assert blob == jget_profile(name).compress_bytes(OBSERVE[:1200])
    assert codec.decompress_bytes(blob) == OBSERVE[:1200]


def test_standard_profile_is_wire_exact():
    got = get_profile("standard", device=CPU).compress_bytes(OBSERVE)
    assert got == jref.lzs_compress(OBSERVE)


@pytest.mark.parametrize("period", [2100, 3000])
@pytest.mark.parametrize("name", ["reach", "flat", "bounded"])
def test_far_offsets_match_jax(name, period):
    """Matches at offsets past 2047 (the run extension's probes carry the
    whole offset): tokens equal JAX's and round-trip."""
    data = repeat_block(period)
    codec = get_profile(name, device=CPU)
    # the tables first: a wrong run length (0 or less) would stall the
    # greedy walk of compress
    arr = np.frombuffer(data, np.uint8).astype(np.int32)
    kw = {"window": codec.window, "cap": codec.search_cap}
    got = stream._best_matches_host(arr, len(data), device=CPU, **kw)
    want = jstream._best_matches_host(arr, len(data), **kw)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g, np.asarray(w))
    toks = codec.compress(data)
    assert toks == jget_profile(name).compress(data)
    if period <= codec.window:
        assert ("match", period) in {t[:2] for t in toks}
    assert codec.decompress(toks) == data
    assert codec.decompress_bytes(codec.encode(toks)) == data


def test_compress_spans_at_most_32768():
    codec = on_cpu(coders.STANDARD_CODEC)
    assert codec.decompress_bytes(codec.compress_bytes(DATA * 4)) == DATA * 4
    with pytest.raises(ValueError, match="32768"):
        codec.compress(bytes(32769))


def test_unknown_profile_keyerror():
    with pytest.raises(KeyError) as port:
        get_profile("nope")
    with pytest.raises(KeyError) as jax_:
        jget_profile("nope")
    assert str(port.value) == str(jax_.value)


def test_profiles_default_to_the_card():
    assert sorted(PROFILES) == sorted(JPROFILES)
    assert coders.GeneralCodec().device == "cuda"
    assert all(p.device == "cuda" for p in PROFILES.values())
    assert get_profile("flat").device == "cuda"
    assert get_profile("flat", device=CPU) == dataclasses.replace(
        PROFILES["flat"], device=CPU)
    assert lzs_tpu_torch.GeneralCodec is coders.GeneralCodec
    assert "GeneralCodec" in lzs_tpu_torch.__all__


@pytest.mark.parametrize("name", sorted(JPROFILES))
def test_general_codec_from_jax(name):
    got = convert.general_codec_from_jax(JPROFILES[name], device=CPU)
    assert got == get_profile(name, device=CPU)
    assert convert.general_codec_from_jax(JPROFILES[name]).device == "cuda"


def test_general_codec_from_jax_rejects_other_objects():
    codec = dataclasses.replace(JPROFILES["standard"], offset_coder=object())
    with pytest.raises(TypeError, match="not a JAX coder"):
        convert.general_codec_from_jax(codec)
