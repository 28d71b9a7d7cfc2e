"""The benchmark's inputs and its reference, on the CPU: the corpus and
the edge cases are the pinned copies, and the reference codec agrees with
the port's plain CPU path at small sizes."""

from __future__ import annotations

import hashlib

import numpy as np
import pytest
import torch

from portbench import corpus
from portbench.reference import lzs

#: SHA-256 over the edge cases (each prefixed by its length, 4 bytes
#: little-endian), as ``bench.selftest_cases`` gives them
CASES_SHA = "2283fd827435947263d24cb0ade90dccca69b0ea51d4cef0153b69b47871d685"


def test_corpus_is_the_pinned_copy():
    data = corpus.make_corpus(1 << 23)
    assert hashlib.sha256(data).hexdigest() == corpus.CORPUS_SHA


def test_edge_cases_are_the_pinned_copy():
    cases = corpus.selftest_cases()
    h = hashlib.sha256()
    for c in cases:
        h.update(len(c).to_bytes(4, "little"))
        h.update(c)
    assert len(cases) == 43
    assert h.hexdigest() == CASES_SHA


def test_corpus_follows_its_seed():
    a = corpus.make_corpus(1 << 16, seed=2**31 + 7)
    assert a == corpus.make_corpus(1 << 16, seed=2**31 + 7)
    assert a != corpus.make_corpus(1 << 16, seed=2**31 + 8)
    assert len(a) == 1 << 16


@pytest.mark.parametrize("index", range(43))
def test_reference_round_trips_each_edge_case(index):
    case = corpus.selftest_cases()[index]
    stream = lzs.compress_block(case)
    assert lzs.decode(stream) == (case, 1)
    assert len(stream) <= lzs.compressed_max(len(case))


def test_reference_decoder_zero_fills_and_cuts_history():
    # a copy of offset 3 at the start reads zeros (source before the block)
    toks = [(0, 3, 4)]
    stream, _, _ = lzs.encode_tokens(b"\0\0\0\0", toks)
    assert lzs.decode(stream) == (b"\0\0\0\0", 1)
    rand = bytes(np.random.default_rng(5).integers(0, 256, 2000,
                                                   dtype=np.uint8))
    data = rand + rand[:200]
    stream = lzs.compress_block(data)
    assert lzs.decode(stream)[0] == data
    # with its history cut below the 2000-byte offset the copy reads zeros
    cut, _ = lzs.decode(stream, window=1024)
    assert len(cut) == len(data) and cut[2000:] == bytes(200)
    assert lzs.decode(stream, cap=10)[0] == data[:10]


def _port_encode(blocks: list[bytes], block: int, span: int):
    from lzs_tpu_torch.ops import encode

    x = np.zeros((len(blocks), block), np.uint8)
    for row, b in zip(x, blocks):
        row[:len(b)] = np.frombuffer(b, np.uint8)
    n = torch.tensor([len(b) for b in blocks], dtype=torch.int32)
    return encode.encode_batch_sync(torch.from_numpy(x), n, span=span)


@pytest.mark.parametrize("block,span", [(4096, 2048), (4096, 256),
                                        (1500, 2048)])
def test_reference_equals_the_ports_cpu_encoder(block, span):
    data = corpus.make_corpus(3 * block, seed=block + span)
    blocks = [data[i * block:(i + 1) * block] for i in range(3)]
    blocks += [b"Q" * block, corpus.selftest_cases()[20][:block]]
    comp, clen, sbit, sout, nsync = _port_encode(blocks, block, span)
    slots = lzs.sync_slots(block, span)
    assert sbit.shape[1] == slots
    for i, b in enumerate(blocks):
        stream, rbit, rout, rn, end = lzs.encode_block_sync(b, span, slots)
        assert bytes(comp[i, :int(clen[i])].numpy()) == stream
        assert int(nsync[i]) == rn
        assert sbit[i].tolist() == rbit
        assert sout[i].tolist() == rout
        assert int(sbit[i, -1]) == end


def test_reference_decodes_what_the_ports_cpu_decoder_decodes():
    from lzs_tpu_torch.ops import decode

    data = corpus.make_corpus(6000, seed=11)
    payloads = [data[:556], data[556:2036], data[2036:2040], b""]
    rows = np.zeros((len(payloads), 2048), np.uint8)
    lens = []
    for row, p in zip(rows, payloads):
        s = lzs.compress_block(p)
        row[:len(s)] = np.frombuffer(s, np.uint8)
        lens.append(len(s))
    out, out_len, markers = decode.decode_batch(
        torch.from_numpy(rows), torch.tensor(lens, dtype=torch.int32),
        out_cap=1500)
    for i, p in enumerate(payloads):
        ref, ref_markers = lzs.decode(bytes(rows[i, :lens[i]]))
        assert ref == p
        assert bytes(out[i, :int(out_len[i])].numpy()) == ref
        assert int(markers[i]) == ref_markers


def test_file_follows_its_seed_with_a_fixed_plan():
    import zlib

    a = corpus.make_file(1 << 20, 2**31 + 7)
    assert a == corpus.make_file(1 << 20, 2**31 + 7) and len(a) == 1 << 20
    files = [corpus.make_file(1 << 20, s) for s in (1, 2, 2**40)]
    assert len({f for f in files}) == 3
    # the same plan: every seed's file compresses alike (make_corpus's
    # files, whose plan follows the seed, differ by several percent)
    sizes = [len(zlib.compress(f, 1)) for f in files]
    assert max(sizes) / min(sizes) < 1.005
