"""lzs_tpu_torch: BlockCodec and the container framing against JAX.

Port and JAX package compress the same inputs (bench corpus pieces, the
golden vector, the empty / 1-byte / RLE probes) to the same container
bytes, greedy and lazy; each decodes the other's blobs, and batch arrays
cross between them through ``lzs_tpu_torch.convert``. The raw payload is
held to the NumPy reference model block by block, and the malformed- and
corrupted-container checks of tests/test_blocks_dist.py are replayed on
the port.
"""

import pathlib
import random
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lzs_tpu import reference as ref
from lzs_tpu.blocks import BlockCodec as JaxCodec
from lzs_tpu_torch import convert
from lzs_tpu_torch.blocks import FLAG_LAZY, BlockCodec, pad_blocks
from lzs_tpu_torch.ops import decode

from golden import GOLDEN_COMPRESSED, GOLDEN_PLAINTEXT

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
from bench import make_corpus  # noqa: E402
from test_blocks_dist import make_corpus as mixed_corpus  # noqa: E402

BLOCK = 2048
CORPUS = make_corpus(1 << 16, seed=3)

# two batch shapes only (1 and 3 blocks): each is one JAX compile
CASES = {
    "empty": b"",
    "one": b"Q",
    "rle": b"A" * 1500,
    "golden": GOLDEN_PLAINTEXT,
    "corpus_a": CORPUS[:5000],
    "corpus_b": CORPUS[20000:26000],
    "mixed": mixed_corpus(5500, seed=4),
}


@pytest.fixture(scope="module")
def codecs():
    return {p: (BlockCodec(block=BLOCK, policy=p, device="cpu"),
                JaxCodec(block=BLOCK, policy=p))
            for p in ("greedy", "lazy")}


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("policy", ["greedy", "lazy"])
def test_container_bytes_match_jax(codecs, policy, name):
    port, jax_codec = codecs[policy]
    data = CASES[name]
    blob = port.compress(data)
    assert blob == jax_codec.compress(data)
    assert port.decompress(blob) == data
    assert bool(blob[5] & FLAG_LAZY) == (policy == "lazy")


@pytest.mark.parametrize("name", ["golden", "corpus_b", "mixed"])
def test_cross_decode(codecs, name):
    port, jax_codec = codecs["greedy"]
    data = CASES[name]
    assert port.decompress(jax_codec.compress(data)) == data
    assert jax_codec.decompress(port.compress(data)) == data
    lazy_port, lazy_jax = codecs["lazy"]
    assert lazy_jax.decompress(lazy_port.compress(data)) == data
    assert port.decompress(lazy_jax.compress(data)) == data


def test_batch_arrays_cross_through_convert(codecs):
    _, jax_codec = codecs["greedy"]
    port = convert.codec_from_jax(jax_codec, device="cpu")
    assert (port.block, port.span, port.policy) == (
        jax_codec.block, jax_codec.span, jax_codec.policy)
    data = CASES["corpus_a"]
    x, lens = pad_blocks(data, BLOCK)

    # JAX encoder -> port decoder
    comp, clen, sbit, sout, nsync = jax_codec.encode_batch(
        jnp.asarray(x), jnp.asarray(lens))
    t = convert.batch_to_torch(dict(comp=comp, clen=clen, sync_bit=sbit,
                                    sync_out=sout, nsync=nsync, n=lens),
                               "cpu")
    assert t["comp"].dtype == torch.uint8 and t["n"].dtype == torch.int32
    out, status = port.decode_batch_status(t["comp"], t["sync_bit"],
                                           t["sync_out"], t["n"])
    assert not status.any()
    assert out.numpy().reshape(-1)[:len(data)].tobytes() == data

    # port encoder -> JAX decoder
    enc = port.encode_batch(torch.from_numpy(x), torch.from_numpy(lens))
    a = convert.batch_to_numpy(dict(zip(
        ("comp", "clen", "sync_bit", "sync_out", "nsync"), enc)))
    for key, want in zip(("comp", "clen", "sync_bit", "sync_out", "nsync"),
                         (comp, clen, sbit, sout, nsync)):
        np.testing.assert_array_equal(a[key], np.asarray(want))
    jout = jax_codec.decode_batch(jnp.asarray(a["comp"]),
                                  jnp.asarray(a["sync_bit"]),
                                  jnp.asarray(a["sync_out"]),
                                  jnp.asarray(lens))
    assert np.asarray(jout).reshape(-1)[:len(data)].tobytes() == data
    with pytest.raises(KeyError):
        convert.batch_to_torch({"weights": np.zeros(1)}, "cpu")


def test_decode_batch_equals_status_and_jax(codecs):
    port, jax_codec = codecs["greedy"]
    x, lens = pad_blocks(CASES["corpus_b"], BLOCK)
    n = torch.from_numpy(lens)
    comp, _, sbit, sout, _ = port.encode_batch(torch.from_numpy(x), n)
    out = port.decode_batch(comp, sbit, sout, n)
    assert torch.equal(out, port.decode_batch_status(comp, sbit, sout, n)[0])
    jout = jax_codec.decode_batch(jnp.asarray(comp.numpy()),
                                  jnp.asarray(sbit.numpy()),
                                  jnp.asarray(sout.numpy()), jnp.asarray(lens))
    np.testing.assert_array_equal(out.numpy(),
                                  np.asarray(jout).astype(np.uint8))
    assert out.numpy().reshape(-1)[:int(n.sum())].tobytes() == \
        CASES["corpus_b"]


@pytest.mark.parametrize("name", ["golden", "corpus_a", "rle", "mixed"])
def test_raw_payload_matches_reference(codecs, name):
    port, _ = codecs["greedy"]
    data = CASES[name]
    raw = port.compress(data, container=False)
    expect = b"".join(ref.lzs_compress(data[s:s + BLOCK])
                      for s in range(0, len(data), BLOCK))
    assert raw == expect
    assert ref.lzs_decompress(raw, stop_at_end=False) == data


def test_golden_vector_single_block():
    port = BlockCodec(block=1024, device="cpu")
    assert port.compress(GOLDEN_PLAINTEXT, container=False) \
        == GOLDEN_COMPRESSED


def test_container_fuzz_rejects_malformed(codecs):
    """Truncated or corrupted headers raise ValueError or decode to the
    original; never another exception (tests/test_blocks_dist.py)."""
    port, _ = codecs["greedy"]
    data = mixed_corpus(9000, seed=13)
    blob = port.compress(data)
    rng = random.Random(99)
    cuts = [0, 3, 4, 12, 23, len(blob) // 2, len(blob) - 1]
    cuts += [rng.randrange(len(blob)) for _ in range(20)]
    for cut in cuts:
        try:
            assert port.decompress(blob[:cut]) == data
        except ValueError:
            pass
    hdr_span = min(len(blob), 24 + 12 * 5 + 40)
    for _ in range(40):
        pos = rng.randrange(hdr_span)
        mut = bytearray(blob)
        mut[pos] ^= 1 << rng.randrange(8)
        try:
            assert isinstance(port.decompress(bytes(mut)), bytes)
        except ValueError:
            pass


def test_container_corruption_is_flagged(codecs):
    """Payload and sync-record corruption raises ValueError or decodes to
    the exact original, never silent garbage (tests/test_blocks_dist.py)."""
    port, _ = codecs["greedy"]
    data = mixed_corpus(9000, seed=21)
    blob = port.compress(data)
    rng = random.Random(7)
    for _ in range(60):
        pos = rng.randrange(28, len(blob))
        mut = bytearray(blob)
        mut[pos] ^= 1 << rng.randrange(8)
        try:
            out = port.decompress(bytes(mut))
        except ValueError:
            continue
        assert out == data, f"silent corruption at byte {pos}"


def test_default_device_is_the_card(codecs):
    """The entry points run on the card unless asked for the CPU; with no
    card the default codec raises at its first use (no automatic choice)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists: the default codec would run")
    codec = BlockCodec(block=1024)
    assert codec.device == torch.device("cuda")
    with pytest.raises((AssertionError, RuntimeError)):
        codec.compress(b"x")
    _, jax_codec = codecs["greedy"]
    assert convert.codec_from_jax(jax_codec).device == torch.device("cuda")
    with pytest.raises((AssertionError, RuntimeError)):
        decode.decode_bytes(GOLDEN_COMPRESSED, 1024)


def test_fields_after_block_are_keyword_only():
    """JAX's codec is (block, chunk, span, policy) and the port's has no
    chunk: a JAX-style positional call raises instead of setting the span,
    and the same keywords build the JAX codec's container bytes."""
    with pytest.raises(TypeError):
        BlockCodec(1 << 15, 4096)
    with pytest.raises(TypeError):
        BlockCodec(BLOCK, 288, "greedy", "cpu")
    port = BlockCodec(BLOCK, span=288, device="cpu")
    assert (port.block, port.span, port.policy) == (BLOCK, 288, "greedy")
    data = CASES["corpus_a"]
    blob = port.compress(data)
    assert blob == JaxCodec(block=BLOCK, span=288).compress(data)
    assert blob != BlockCodec(block=BLOCK, device="cpu").compress(data)


def test_container_wrong_magic_version_and_codec(codecs):
    port, _ = codecs["greedy"]
    blob = port.compress(mixed_corpus(3000, seed=14))
    for bad in (b"XXXX" + blob[4:], blob[:4] + bytes([99]) + blob[5:], b"",
                blob[:5] + bytes([0x80]) + blob[6:]):
        with pytest.raises(ValueError):
            port.decompress(bad)
    with pytest.raises(ValueError):
        BlockCodec(block=4096, device="cpu").decompress(blob)
    with pytest.raises(ValueError):
        BlockCodec(policy="fast", device="cpu")
