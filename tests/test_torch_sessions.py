"""lzs_tpu_torch.SessionCodec: one carried history a link, on the CPU.

* ``ops.encode.encode_batch`` with ``start`` None or 0 gives the
  stateless bytes (the port's NumPy model, the C encoder's bytes).
* ``SessionCodec(device="cpu")`` at batch 32 and more, over many calls
  of packets of 0 to 1500 bytes, equals the plain reference
  ``portbench.reference.sessions.compress_with_history`` of each packet
  against its link's last 2047 plaintext bytes: partial histories, a
  match exactly 2047 bytes back (and a miss at 2048), runs whose source
  crosses from the history into the packet, packets that repeat their
  history (runs into extension nibbles), empty packets.
* A reset link gives ``encode_batch``'s stateless bytes; the histories
  are the links' plaintext tails; a link's streams, concatenated, decode
  through ``StreamDecompressor`` in one session and through the
  reference's ``decode_with_history``.
"""

import numpy as np
import pytest
import torch

from lzs_tpu_torch import SessionCodec, StreamDecompressor, reference, trace
from lzs_tpu_torch.ops import encode
from lzs_tpu_torch.sessions import HISTORY
from portbench.reference import sessions as ref

CPU = "cpu"
MTU = 1500


def _text(rng: np.random.Generator, size: int) -> bytes:
    """Compressible bytes: words from a small vocabulary, byte runs and
    random spans."""
    words = [bytes(rng.integers(97, 123, int(k), dtype=np.uint8))
             for k in rng.integers(2, 9, 60)]
    out = bytearray()
    while len(out) < size:
        k = int(rng.integers(0, 10))
        if k < 6:
            out += words[int(rng.integers(0, len(words)))] + b" "
        elif k < 8:
            out += bytes([int(rng.integers(0, 256))]) * int(
                rng.integers(2, 40))
        else:
            out += bytes(rng.integers(0, 256, int(rng.integers(1, 30)),
                                      dtype=np.uint8))
    return bytes(out[:size])


def _batch(packets: list[bytes], mtu: int = MTU):
    x = np.zeros((len(packets), mtu), np.uint8)
    for row, p in zip(x, packets):
        row[:len(p)] = np.frombuffer(p, np.uint8)
    return (torch.from_numpy(x),
            torch.tensor([len(p) for p in packets], dtype=torch.int32))


def _streams(comp, nbytes) -> list[bytes]:
    return [bytes(r[:k]) for r, k in zip(comp.numpy(), nbytes.tolist())]


@pytest.mark.parametrize("seed,width", [(0, 1), (1, 300), (2, 1500),
                                        (3, 3547), (4, 4096)])
def test_start_none_or_zero_gives_stateless_bytes(seed, width):
    rng = np.random.default_rng(seed)
    data = [_text(rng, int(k)) for k in rng.integers(0, width + 1, 6)]
    x, n = _batch(data, width)
    want = [reference.lzs_compress(d) for d in data]
    for start in (None, torch.zeros(len(data), dtype=torch.int32)):
        comp, nbytes = encode.encode_batch(x, n, start=start)
        assert _streams(comp, nbytes) == want


def _plan(seed: int, sessions: int, calls: int):
    """Each link's packets a call: lengths of 0 to 1500, the cases named
    in the module docstring on links 0-5, the rest from ``_text``."""
    rng = np.random.default_rng(seed)
    probe = bytes(rng.integers(0, 256, 16, dtype=np.uint8))
    plain = [_text(rng, 12000) for _ in range(sessions)]
    # links 0 and 1: a probe exactly 2047 (a hit) and 2048 (a miss) bytes
    # before its repeat, in the third call's packet
    for s, gap in ((0, HISTORY), (1, HISTORY + 1)):
        head = probe + b"\xAA" * (gap - len(probe))
        plain[s] = head + probe + plain[s][:12000 - len(head) - 16]
    # link 2: a period of 7 bytes, runs across every packet boundary
    plain[2] = (b"abcdefg" * 2000)[:12000]
    lens = rng.integers(0, MTU + 1, (calls, sessions))
    lens[:, 3] = [40, 1500, 0, 576, 1500, 1, 700][:calls]
    lens[:2, 0] = lens[:2, 1] = [1000, 1047]
    lens[2, 0], lens[2, 1] = 600, 601
    lens[:, 4] = 0                               # a link that sends nothing
    lens[0, 5], lens[1:, 5] = 1500, 1500
    # link 3 ends on a repeat of its history; link 5 repeats its packet
    p3 = plain[3][:sum(lens[:6, 3])]
    plain[3] = p3 + p3[-1500:] + plain[3]
    plain[5] = plain[5][:1500] * 8
    packets, at = [], np.zeros(sessions, np.int64)
    for c in range(calls):
        row = []
        for s in range(sessions):
            k = int(lens[c, s])
            row.append(plain[s][at[s]:at[s] + k])
            at[s] += k
        packets.append(row)
    return packets


def test_sessions_equal_reference():
    sessions, calls = 34, 7
    packets = _plan(5, sessions, calls)
    codec = SessionCodec(sessions, mtu=MTU, device=CPU)
    sent = [b""] * sessions
    out = [b""] * sessions
    long_runs = 0
    for c in range(calls):
        comp, nbytes = codec.compress(*_batch(packets[c]))
        assert comp.shape == (sessions, encode.cap_bytes(MTU))
        got = _streams(comp, nbytes)
        for s in range(sessions):
            want = ref.compress_with_history(sent[s], packets[c][s])
            assert got[s] == want, (c, s)
            back, markers = ref.decode_with_history(sent[s], got[s])
            assert back == packets[c][s] and markers == 1
            sent[s] += packets[c][s]
            out[s] += got[s]
            assert codec.history(s) == sent[s][-HISTORY:]
        if c == 2:
            # link 0's probe repeats exactly 2047 bytes back, at the
            # packet's start; link 1's 2048 back, one byte into it
            for s, at, offset in ((0, 0, HISTORY), (1, 1, 0)):
                toks = ref.greedy_tokens_from(sent[s], HISTORY)
                assert any(i == HISTORY + at and d == offset
                           for i, d, _ in toks)
        long_runs += sum(
            length >= 23 for _, d, length in ref.greedy_tokens_from(
                sent[3], len(sent[3]) - len(packets[c][3])) if d)
    assert long_runs > 0
    assert codec.calls == calls
    assert codec.rows_compressed == calls * sessions
    hlen = codec.hlen.tolist()
    assert hlen == [min(len(p), HISTORY) for p in sent]
    for s in range(sessions):
        rx = StreamDecompressor()
        assert rx.feed(out[s]) == sent[s]
        assert rx.markers == calls


def test_empty_packet_keeps_history_and_emits_the_marker():
    codec = SessionCodec(32, mtu=MTU, device=CPU)
    rng = np.random.default_rng(9)
    first = [_text(rng, 900) for _ in range(32)]
    codec.compress(*_batch(first))
    before = codec.hist.clone(), codec.hlen.clone()
    comp, nbytes = codec.compress(*_batch([b""] * 32))
    assert nbytes.tolist() == [2] * 32
    assert _streams(comp, nbytes) == [reference.lzs_compress(b"")] * 32
    assert torch.equal(codec.hist, before[0])
    assert torch.equal(codec.hlen, before[1])


def test_reset_rows_give_stateless_bytes():
    sessions = 32
    rng = np.random.default_rng(11)
    codec = SessionCodec(sessions, mtu=MTU, device=CPU)
    codec.compress(*_batch([_text(rng, 1500) for _ in range(sessions)]))
    mask = np.zeros(sessions, bool)
    mask[::3] = True
    codec.reset(mask)
    codec.reset([1, 2])
    assert codec.rows_reset == mask.sum() + 2
    gone = mask.copy()
    gone[[1, 2]] = True
    assert (codec.hlen.numpy() == 0).tolist() == gone.tolist()
    assert not codec.hist[torch.from_numpy(gone)].any()
    packets = [_text(rng, int(k)) for k in rng.integers(0, 1501, sessions)]
    x, n = _batch(packets)
    got = _streams(*codec.compress(x, n))
    stateless = _streams(*encode.encode_batch(x, n))
    assert [g for g, r in zip(got, gone) if r] == [
        t for t, r in zip(stateless, gone) if r]
    assert any(g != t for g, t, r in zip(got, stateless, gone) if not r)
    for s in np.flatnonzero(gone):
        assert codec.history(int(s)) == packets[s]


def test_state_round_trip():
    rng = np.random.default_rng(12)
    a = SessionCodec(32, mtu=MTU, device=CPU)
    for size in (1200, 1400):
        a.compress(*_batch([_text(rng, size) for _ in range(32)]))
    b = SessionCodec(32, mtu=MTU, device=CPU)
    state = a.state_dict()
    b.load_state_dict(state)
    a.compress(*_batch([b"q" * 1500] * 32))
    assert not torch.equal(state["hist"], a.hist)
    b.load_state_dict(state)
    a.load_state_dict(state)
    packets = [_text(rng, 700) for _ in range(32)]
    assert _streams(*a.compress(*_batch(packets))) == _streams(
        *b.compress(*_batch(packets)))
    with pytest.raises(ValueError):
        SessionCodec(16, mtu=MTU, device=CPU).load_state_dict(a.state_dict())


def test_bad_packets_raise():
    codec = SessionCodec(32, mtu=100, device=CPU)
    x, n = _batch([b"a" * 100] * 32, 100)
    n[5] = 101
    with pytest.raises(ValueError):
        codec.compress(x, n)
    n[5] = -1
    with pytest.raises(ValueError):
        codec.compress(x, n)
    with pytest.raises(ValueError):
        codec.compress(x[:, :50], n.clamp(0, 50))
    with pytest.raises(ValueError):
        SessionCodec(4, mtu=(1 << 15) - HISTORY + 1, device=CPU)
    assert codec.calls == 0


def test_history_stage_wraps_assembly_and_update():
    codec = SessionCodec(32, mtu=64, device=CPU)
    with trace.stage_times() as times:
        codec.compress(*_batch([b"hello hello"] * 32, 64))
    assert trace.SESSION_STAGES == ("history",)
    assert set(times) >= {"history", "candidates", "extend", "units",
                          "pack"}
