"""lzs_tpu_torch: the exhaustive match backend and the one-block entry
points vs JAX.

The same seeded inputs (made with numpy) go through the JAX package on
the CPU (Pallas in interpret mode) and the port on CPU tensors; every
output must be equal, tolerance 0:

* ``ops.match.best_matches`` (the brute-force plane; its reverse cummin
  is K7 ``pext.rcummin_rows`` on the card) at sizes 256 to 4096 and
  32768 (JAX at chunk 256, so that it builds no 512 MiB plane), window
  limits 2047 and smaller, its batch form at batch 33;
* ``sortmatch.best_matches`` / ``candidates`` against JAX's one-block
  forms, and ``stream._best_matches_host`` for both backends at pools
  256, 2048 and 32768;
* ``tokenize.emission_units``, ``bitpack.pack_bits`` /
  ``words_to_bytes`` / ``read_window``;
* ``encode.encode_block``, ``encode_block_sync``, ``encode_bytes``,
  ``make_encoder`` (both backends, both policies, batch 33) and
  ``decode2.decode_block_sync`` / ``make_decoder_sync``.

Then the port's counterparts of ``test_ops.py``'s encode tests and of
``test_sortmatch_batch.py::test_exhaustive_backend_matches_sort_backend``,
held to the port's NumPy reference model (itself held to JAX's in
``test_torch_stream.py``).
"""

import pathlib
import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lzs_tpu import stream as jstream
from lzs_tpu.ops import bitpack as jbp
from lzs_tpu.ops import decode2 as jdec2
from lzs_tpu.ops import encode as jenc
from lzs_tpu.ops import match as jmatch
from lzs_tpu.ops import sortmatch as jsm
from lzs_tpu.ops import tokenize as jtok
from lzs_tpu_torch import reference as ref
from lzs_tpu_torch import stream
from lzs_tpu_torch.ops import (bitpack, decode, decode2, encode, match,
                               sortmatch, tokenize)

from golden import (GOLDEN_COMPRESSED, GOLDEN_PLAINTEXT,
                    uncompressible_sequence)
from test_torch_pcand import mixed_blocks

CPU = "cpu"


def _t(a):
    return torch.from_numpy(np.array(a))


def _block(seed: int, npos: int, short: int = 17):
    """One seeded block of ``npos`` int32 bytes (zeros past n) and n:
    a tiny alphabet, a 16-byte period, random bytes or RLE runs by seed,
    with a random stretch and a copy from far back laid over it."""
    rng = np.random.default_rng(seed)
    kinds = [lambda: rng.integers(0, 4, npos) + 97,
             lambda: np.tile(rng.integers(0, 256, 16), npos // 16 + 1),
             lambda: rng.integers(0, 256, npos),
             lambda: np.repeat(rng.integers(0, 256, npos // 64 + 1), 64)]
    x = kinds[seed % 4]()[:npos].astype(np.int32)
    a = int(rng.integers(0, npos // 2 + 1))
    x[a:a + npos // 8] = rng.integers(0, 256, len(x[a:a + npos // 8]))
    if npos >= 64:
        src, m = int(rng.integers(0, npos // 4)), npos // 8
        dst = int(rng.integers(src + 1, npos - m + 1))
        x[dst:dst + m] = x[src:src + m].copy()
    n = max(npos - short, 1)
    x[n:] = 0
    return x, n


def _equal(got, want):
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(
            g.numpy() if torch.is_tensor(g) else np.asarray(g),
            np.asarray(w))


# --- the exhaustive backend ---------------------------------------------

@pytest.mark.parametrize("npos,window,jchunk", [
    (256, 2047, 256), (512, 2047, 512), (1024, 2047, 4096),
    (2048, 100, 64), (4096, 2047, 256), (1024, 7, 256), (300, 1, 256)])
def test_match_best_matches_equals_jax(npos, window, jchunk):
    x, n = _block(npos + window, npos)
    want = jmatch.best_matches(jnp.asarray(x), jnp.int32(n), window=window,
                               chunk=jchunk)
    got = match.best_matches(_t(x), torch.tensor(n), window=window)
    _equal(got, want)


def test_match_best_matches_32768_equals_jax():
    x, n = _block(7, 1 << 15, short=1000)
    want = jmatch.best_matches(jnp.asarray(x), jnp.int32(n), chunk=256)
    _equal(match.best_matches(_t(x), torch.tensor(n)), want)


def test_match_quirks_kept():
    """No match: off 1 and the run at d = 1; a score of 1 where only a
    1-byte run exists; 0 at n and a negative score past it (as JAX)."""
    x = np.array([5, 5, 9, 5, 0, 0, 0, 0], np.int32)
    s, o, f = match.best_matches(_t(x), torch.tensor(4))
    assert int(s[0]) == 0 and int(o[0]) == 1 and int(f[0]) == 0
    assert int(s[2]) == 0 and int(o[2]) == 1
    assert int(s[3]) == 1
    assert int(s[4]) == 0 and (s[5:] < 0).all()
    _equal((s, o, f), jmatch.best_matches(jnp.asarray(x), jnp.int32(4)))


@pytest.mark.parametrize("chunk", [1, 100, 256, 2047, 4096])
def test_match_result_independent_of_chunk(chunk):
    x, n = _block(3, 700)
    base = match.best_matches(_t(x), torch.tensor(n))
    _equal(match.best_matches(_t(x), torch.tensor(n), chunk=chunk),
           [b.numpy() for b in base])


def test_match_rejects_bad_window_and_chunk():
    x = torch.zeros(8, dtype=torch.int32)
    for kw in ({"window": 0}, {"window": 2048}, {"chunk": 0}):
        with pytest.raises(ValueError):
            match.best_matches(x, torch.tensor(8), **kw)


def test_match_batch_33_equals_jax_vmap():
    x, n = mixed_blocks(33, 33, 512)
    n[5], n[6] = 0, 1
    want = jax.jit(jax.vmap(jmatch.best_matches))(jnp.asarray(x),
                                                  jnp.asarray(n))
    _equal(match.best_matches_batch(_t(x), _t(n)), want)


# --- one-block sort forms and the stream's match table ------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_sortmatch_one_block_forms_equal_jax(seed):
    x, n = _block(seed, 2048, short=40 * seed)
    xj, nj = jnp.asarray(x), jnp.int32(n)
    _equal(sortmatch.candidates(_t(x), torch.tensor(n)),
           jax.jit(jsm.candidates)(xj, nj))
    _equal(sortmatch.best_matches(_t(x), torch.tensor(n)),
           jsm.best_matches(xj, nj))


@pytest.mark.parametrize("backend", ["sort", "exhaustive"])
@pytest.mark.parametrize("n", [200, 2000, 32768])
def test_best_matches_host_equals_jax(backend, n):
    rng = np.random.default_rng(n)
    arr = np.repeat(rng.integers(0, 6, n // 3 + 1), 3)[:n].astype(np.int32)
    arr[: n // 5] = rng.integers(0, 256, n // 5)
    got = stream._best_matches_host(arr, n, backend=backend, device=CPU)
    if backend == "exhaustive" and n > 4096:
        # JAX's matcher folds min(4096, pool) offsets (a 512 MiB plane
        # here); the result does not depend on the fold, so hold the
        # port to JAX's plane at chunk 256 on the same padded pool
        x = np.zeros(32768, np.int32)
        x[:n] = arr
        want = jmatch.best_matches(jnp.asarray(x), jnp.int32(n), chunk=256)
    else:
        want = jstream._best_matches_host(arr, n, backend=backend)
    for g, w in zip(got, want, strict=True):
        assert isinstance(g, np.ndarray) and g.dtype == np.int32
        np.testing.assert_array_equal(g, np.asarray(w))


def test_best_matches_host_rejects_wide_span_and_backend():
    arr = np.zeros(40000, np.int32)
    with pytest.raises(ValueError):
        stream._best_matches_host(arr, 32769, device=CPU)
    with pytest.raises(ValueError):
        stream._best_matches_host(arr, 100, backend="hash", device=CPU)


# --- emission units and the bit pack ------------------------------------

def test_emission_units_equals_jax():
    x, n = _block(11, 2048, short=100)
    xj, nj = jnp.asarray(x), jnp.int32(n)
    s, o, f = jsm.best_matches(xj, nj)
    want = jtok.emission_units(xj, nj, s, o, f)
    got = tokenize.emission_units(_t(x), torch.tensor(n), _t(s), _t(o),
                                  _t(f))
    _equal(got, want)


@pytest.mark.parametrize("end_marker", [None, (0b110000000, 9)])
def test_pack_bits_equals_jax(end_marker):
    rng = np.random.default_rng(4)
    m = 3000
    width = rng.integers(0, 26, m).astype(np.int32)
    width[rng.random(m) < 0.3] = 0
    value = (rng.integers(0, 1 << 25, m) & ((1 << width) - 1)).astype(
        np.int32)
    cap = -(-int(width.sum() + 9) // 32) * 4 + 8
    want = jbp.pack_bits(jnp.asarray(value), jnp.asarray(width), cap,
                         end_marker=end_marker)
    got = bitpack.pack_bits(_t(value), _t(width), cap, end_marker=end_marker)
    _equal(got, want)


def test_words_to_bytes_and_read_window_equal_jax():
    rng = np.random.default_rng(5)
    words = rng.integers(-(1 << 31), 1 << 31, (3, 40), dtype=np.int64).astype(
        np.int32)
    _equal([bitpack.words_to_bytes(_t(words))],
           [jbp.words_to_bytes(jnp.asarray(words))])
    data = np.concatenate([rng.integers(0, 256, 200), np.zeros(4)]).astype(
        np.int32)
    bitpos = rng.integers(0, 200 * 8, 500).astype(np.int32)
    want = np.asarray(jbp.read_window(jnp.asarray(data), jnp.asarray(bitpos)))
    got = bitpack.read_window(_t(data), _t(bitpos))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


# --- one-block encode and decode, the factories -------------------------

@pytest.mark.parametrize("backend", ["sort", "exhaustive"])
def test_encode_block_equals_jax(backend):
    x, n = _block(21, 2048, short=300)
    xj, nj = jnp.asarray(x.astype(np.uint8)), jnp.int32(n)
    want = jenc.encode_block(xj, nj, backend=backend)
    got = encode.encode_block(_t(x.astype(np.uint8)), torch.tensor(n),
                              backend=backend)
    _equal(got, want)


def test_encode_block_sync_and_decode_block_sync_equal_jax():
    x, n = _block(22, 2048, short=5)
    xj, nj = jnp.asarray(x.astype(np.uint8)), jnp.int32(n)
    want = jenc.encode_block_sync(xj, nj, span=288)
    got = encode.encode_block_sync(_t(x.astype(np.uint8)), torch.tensor(n),
                                   span=288)
    _equal(got, want)
    comp, _, sbit, sout, _ = want
    wout = jdec2.decode_block_sync(comp, sbit, sout, nj, out_cap=2048,
                                   span=288)
    gout = decode2.decode_block_sync(*got[:1], *got[2:4], torch.tensor(n),
                                     out_cap=2048, span=288)
    _equal([gout], [wout])
    assert gout[:n].numpy().tobytes() == x[:n].astype(np.uint8).tobytes()


def test_sync_scan_len_equals_jax():
    for span in (64, 96, 288, 2048):
        assert encode.sync_scan_len(span) == jenc.sync_scan_len(span)
    assert encode.MIN_STEP_BITS == jenc.MIN_STEP_BITS


@pytest.mark.parametrize("policy", ["greedy", "lazy"])
@pytest.mark.parametrize("backend", ["sort", "exhaustive"])
def test_make_encoder_batch_33_equals_jax(backend, policy):
    x, n = mixed_blocks(40, 33, 512)
    n[3], n[4] = 0, 1
    xb = x.astype(np.uint8)
    want = jenc.make_encoder(512, backend=backend, policy=policy, sync=True,
                             span=96)(jnp.asarray(xb), jnp.asarray(n))
    got = encode.make_encoder(backend=backend, policy=policy, sync=True,
                              span=96)(_t(xb), _t(n))
    _equal(got, want)
    # the plain encoder's bytes are the sync encoder's
    _equal(encode.make_encoder(backend=backend, policy=policy)(
        _t(xb), _t(n)), got[:2])
    comp, _, sbit, sout, _ = want
    out = decode2.make_decoder_sync(512, span=96)(
        _t(comp), _t(sbit), _t(sout), _t(n))
    for b in range(33):
        assert out[b, :n[b]].numpy().tobytes() == xb[b, :n[b]].tobytes()
    if (backend, policy) == ("sort", "greedy"):
        _equal([out], [jdec2.make_decoder_sync(comp.shape[1], 512, span=96)(
            comp, sbit, sout, jnp.asarray(n))])


def test_encode_bytes_equals_jax_and_reference():
    data = (GOLDEN_PLAINTEXT * 40)[:9000] + uncompressible_sequence()
    got = encode.encode_bytes(data, block=4096, device=CPU)
    assert got == jenc.encode_bytes(data, block=4096)
    want = b"".join(ref.lzs_compress(data[s:s + 4096])
                    for s in range(0, len(data), 4096))
    assert got == want
    assert encode.encode_bytes(b"", block=256, device=CPU) == \
        ref.lzs_compress(b"")


def test_entry_points_reject_unknown_backend():
    x = torch.zeros((1, 256), dtype=torch.uint8)
    n = torch.tensor([10], dtype=torch.int32)
    with pytest.raises(ValueError):
        encode.encode_batch(x, n, backend="hash")
    with pytest.raises(ValueError):
        encode.encode_batch(x, n, policy="eager")


# --- counterparts of test_ops.py / test_sortmatch_batch.py --------------

def port_encode(data: bytes, block: int = 2048,
                backend: str = "sort") -> bytes:
    x = np.zeros(block, np.uint8)
    x[:len(data)] = np.frombuffer(data, np.uint8)
    comp, nbytes = encode.encode_block(_t(x), torch.tensor(len(data)),
                                       backend=backend)
    return comp[:int(nbytes)].numpy().tobytes()


def port_decode(data: bytes, out_cap: int = 4096) -> bytes:
    return decode.decode_bytes(data, out_cap, device=CPU)


CASES = [
    ("empty", b""),
    ("one", b"Q"),
    ("two_same", b"XX"),
    ("three_same", b"XXX"),
    ("golden", GOLDEN_PLAINTEXT),
    ("uncompressible", uncompressible_sequence()),
    ("rle_long", b"A" * 1500),
    ("rle_boundary8", b"ABCD" + b"Z" * 9),
    ("rle_nibble_edge15", b"Q" + b"Q" * 23),
    ("rle_nibble_edge30", b"Q" + b"Q" * 38),
    ("alternating", b"ab" * 700),
    ("text", (GOLDEN_PLAINTEXT * 5)[:1900]),
]


@pytest.mark.parametrize("backend", ["sort", "exhaustive"])
@pytest.mark.parametrize("name,data", CASES)
def test_encode_matches_oracle(name, data, backend):
    assert port_encode(data, backend=backend) == ref.lzs_compress(data)


def test_golden_vector():
    assert port_encode(GOLDEN_PLAINTEXT, block=1024) == GOLDEN_COMPRESSED
    assert port_decode(GOLDEN_COMPRESSED) == GOLDEN_PLAINTEXT


def test_random_fuzz_vs_oracle():
    rng = random.Random(123)
    for trial in range(10):
        parts = []
        for _ in range(rng.randrange(1, 25)):
            k = rng.randrange(4)
            if k == 0:
                parts.append(bytes(rng.randrange(256)
                                   for _ in range(rng.randrange(1, 50))))
            elif k == 1:
                parts.append(bytes([rng.randrange(256)])
                             * rng.randrange(1, 120))
            elif k == 2:
                parts.append(b"lorem ipsum dolor " * rng.randrange(1, 6))
            else:
                parts.append(bytes([rng.randrange(4)])
                             * rng.randrange(1, 20))
        data = b"".join(parts)[:2048]
        expect = ref.lzs_compress(data)
        assert port_encode(data) == expect, f"trial {trial} len {len(data)}"
        assert port_decode(expect) == data


def test_steal_heavy_fuzz_vs_oracle():
    """Far-offset capped runs stolen by a nearer offset mid-run, nested
    periods, matches to exactly the data end, offset switches mid-run."""
    rng = random.Random(99)
    for trial in range(25):
        parts = []
        for _ in range(rng.randrange(2, 6)):
            k = rng.randrange(5)
            if k == 0:
                p = rng.randrange(17, 300)
                unit = bytes(rng.randrange(256) for _ in range(p))
                parts.append(unit * rng.randrange(2, 8))
            elif k == 1:
                u = bytes(rng.randrange(256) for _ in range(40))
                parts.append((u * 5) * rng.randrange(2, 4))
            elif k == 2:
                u = bytes(rng.randrange(256)
                          for _ in range(rng.randrange(20, 60)))
                parts.append(u + u)
            elif k == 3:
                parts.append(bytes(rng.randrange(256)
                                   for _ in range(rng.randrange(10, 80))))
            else:
                u = bytes(rng.randrange(256)
                          for _ in range(rng.randrange(13, 30)))
                filler = bytes(rng.randrange(256)
                               for _ in range(rng.randrange(1, 200)))
                parts.append(u + filler + u + u)
        data = b"".join(parts)[:4096]
        expect = ref.lzs_compress(data)
        assert port_encode(data, block=4096) == expect, f"trial {trial}"


@pytest.mark.parametrize("backend", ["sort", "exhaustive"])
def test_window_limit_2047(backend):
    pat = b"ZYXWVU"
    far = pat + bytes((i * 31 + 7) % 251 for i in range(2047 - len(pat))) + pat
    assert port_encode(far, 4096, backend) == ref.lzs_compress(far)
    farther = pat + bytes((i * 31 + 7) % 251
                          for i in range(2048 - len(pat))) + pat
    assert port_encode(farther, 4096, backend) == ref.lzs_compress(farther)


def test_batch_vmap():
    enc = encode.make_encoder()
    datas = [b"hello world " * 20, b"A" * 400, bytes(range(256)), b"", b"xyz"]
    nb = len(datas)
    x = np.zeros((nb, 512), np.uint8)
    n = np.zeros(nb, np.int32)
    for b, d in enumerate(datas):
        x[b, :len(d)] = np.frombuffer(d, np.uint8)
        n[b] = len(d)
    comp, nbytes = enc(_t(x), _t(n))
    streams = [comp[b, :int(nbytes[b])].numpy().tobytes() for b in range(nb)]
    for d, s in zip(datas, streams):
        assert s == ref.lzs_compress(d)

    cap = comp.shape[1]
    dec = decode.make_decoder(cap, 512)
    cbuf = np.zeros((nb, cap), np.uint8)
    for b, s in enumerate(streams):
        cbuf[b, :len(s)] = np.frombuffer(s, np.uint8)
    out, out_len, markers = dec(_t(cbuf), nbytes)
    for b, d in enumerate(datas):
        assert out[b, :int(out_len[b])].numpy().tobytes() == d
        assert int(markers[b]) == 1


def test_lazy_policy_roundtrip_and_size():
    """The lazy policy emits valid LZS streams (read back by the raw
    decoder) no larger than greedy's, on text from the repository."""
    root = pathlib.Path(__file__).resolve().parent.parent
    datas = [(root / "lzs_tpu" / "reference.py").read_bytes(),
             (root / "native" / "lzs_native.cpp").read_bytes(),
             b"lorem ipsum dolor sit amet " * 300]
    block = 8192
    for data in datas:
        data = data[:block]
        x = np.zeros(block, np.uint8)
        x[:len(data)] = np.frombuffer(data, np.uint8)
        cg, ng = encode.encode_block(_t(x), torch.tensor(len(data)))
        cl, nl = encode.encode_block(_t(x), torch.tensor(len(data)),
                                     policy="lazy")
        assert int(nl) <= int(ng), (int(nl), int(ng))
        out, out_len, _ = decode.decode_block(cl, nl, out_cap=block)
        assert int(out_len) == len(data)
        assert out[:len(data)].numpy().tobytes() == data


def test_exhaustive_backend_matches_sort_backend():
    """The two backends agree at every position where either matches
    (below MIN_MATCH they encode "no match" differently: 0 against a
    degenerate run), and encode_block gives the same bytes on both."""
    for seed in range(3):
        x, n = _block(100 + seed, 2048, short=seed * 21)
        es, eo, ef = (a.numpy() for a in match.best_matches(
            _t(x), torch.tensor(n)))
        ss, so, sf = (a.numpy() for a in sortmatch.best_matches(
            _t(x), torch.tensor(n)))
        em, sm = es >= 2, ss >= 2
        np.testing.assert_array_equal(em, sm)
        for e, s in ((es, ss), (eo, so), (ef, sf)):
            np.testing.assert_array_equal(np.where(em, e, 0),
                                          np.where(sm, s, 0))
    x, n = _block(103, 2048, short=0)
    xt = _t(x.astype(np.uint8))
    ce, ne = encode.encode_block(xt, torch.tensor(n), backend="exhaustive")
    cs, ns = encode.encode_block(xt, torch.tensor(n), backend="sort")
    assert int(ne) == int(ns)
    assert torch.equal(ce, cs)
