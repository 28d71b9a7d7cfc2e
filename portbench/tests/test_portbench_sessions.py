"""The two compress cells of the session configuration on the CPU at a
small size: the stateful PPP sessions (``ppp-stac-1500.session-compress``)
and the IPComp sender (``ipcomp-1500.compress``). Each runs ``correct``
true; the sessions' check finds histories dropped and histories one
packet stale; the inputs follow the seed; the readers of the new
metrics read a canned trace."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import roofline, roofline_session, run, tracing
from portbench.drivers import datagram_compress, session_compress
from portbench.reference import lzs, sessions as ref
from small import BENCH, SEED

SESSION = "ppp-stac-1500.session-compress"
SENDER = "ipcomp-1500.compress"
SMALL = {
    SESSION: {"sessions": 32, "packet_mix": [[576, 16], [1500, 16]],
              "corpus_bytes": 1 << 16, "plan_calls": 2,
              "check_sessions": 6, "warm_calls": 1},
    SENDER: {"corpus_bytes": 1 << 16,
             "payload_mix": [[556, 16], [1480, 8]], "check_streams": 6,
             "warm_calls": 1},
}


def _run(cell: str) -> dict:
    return run.run_cell(BENCH, cell, SEED, 0.5, False, device="cpu",
                        traffic=SMALL[cell])


def _work(module, cell, seed):
    c = run.Cell(BENCH, cell)
    c.traffic.update(SMALL[cell])
    return module.Work(c.config["codec"], c.traffic, seed, "cpu")


def test_benchmark_has_six_cells_two_new():
    cells = [w["name"] for w in BENCH["workloads"]]
    assert len(cells) == 6 and cells[-2:] == [SESSION, SENDER]
    for cell in (SESSION, SENDER):
        c = run.Cell(BENCH, cell)
        assert c.chips == 1
        assert c.end_to_end == ["compress_gbps", "setup_s"]
    assert set(run.Cell(BENCH, SESSION).per_layer) == {
        "p95_call_ms.compress", "match_search_ms", "emit_ms",
        "idle_pct.compress", "history_ms.session", "roofline_pct.session"}
    assert set(run.Cell(BENCH, SENDER).per_layer) == {
        "p95_call_ms.compress", "match_search_ms", "emit_ms",
        "idle_pct.compress", "roofline_pct.compress"}


@pytest.mark.parametrize("cell", [SESSION, SENDER])
def test_sound_runs_are_correct(cell):
    line = _run(cell)
    assert line["correct"] is True, line["checks"]
    assert set(line["metrics"]) == {"compress_gbps", "setup_s"}
    for c in line["checks"].values():
        assert c == {"value": 0, "limit": 0}


def test_histories_dropped_are_found(monkeypatch):
    """Every packet compressed alone, the histories kept as they should."""
    from lzs_tpu_torch import SessionCodec
    from lzs_tpu_torch.ops import encode

    real = SessionCodec.compress

    def stateless(self, x, n):
        real(self, x, n)
        comp, nbytes = encode.encode_batch(x, n)
        return comp[:, :self.cap], nbytes

    monkeypatch.setattr(SessionCodec, "compress", stateless)
    line = _run(SESSION)
    assert line["correct"] is False
    assert line["checks"]["streams_unlike_reference"]["value"] > 0


def test_histories_one_packet_stale_are_found(monkeypatch):
    """Every packet compressed against its link's history of one packet
    earlier, the histories kept as they should."""
    from lzs_tpu_torch import SessionCodec

    real = SessionCodec.compress

    def stale(self, x, n):
        before = getattr(self, "_before", None)
        self._before = self.state_dict()
        if before is None:
            return real(self, x, n)
        old = SessionCodec(self.sessions, mtu=self.mtu, device=self.device)
        old.load_state_dict(before)
        out = real(old, x, n)
        real(self, x, n)
        return out

    monkeypatch.setattr(SessionCodec, "compress", stale)
    line = _run(SESSION)
    assert line["correct"] is False
    assert line["checks"]["streams_unlike_reference"]["value"] > 0


def test_sender_altered_streams_are_found(monkeypatch):
    from lzs_tpu_torch.ops import encode

    real = encode.encode_batch

    def altered(x, n, **kw):
        comp, nbytes = real(x, n, **kw)
        comp = comp.clone()
        comp[:, 3] ^= 0x10
        return comp, nbytes

    monkeypatch.setattr(encode, "encode_batch", altered)
    assert _run(SENDER)["correct"] is False


@pytest.mark.parametrize("seed", [SEED, 7, 2**40 + 3])
def test_session_plan_follows_the_seed(seed):
    a = _work(session_compress, SESSION, seed)
    b = _work(session_compress, SESSION, seed)
    c = _work(session_compress, SESSION, seed + 1)
    assert torch.equal(a.plan_x, b.plan_x) and torch.equal(a.codec.hist,
                                                           b.codec.hist)
    assert not torch.equal(a.plan_x, c.plan_x)
    # every seed sends the same lengths a call, in an order of its own
    for la, lc in zip(a.lens, c.lens):
        assert sorted(la) == sorted(lc)
    assert a.bytes_per_call == c.bytes_per_call == 16 * 576 + 16 * 1500
    assert a.sizes == c.sizes
    assert (a.codec.hlen == 2047).all()


def test_session_plan_is_each_links_plaintext():
    w = _work(session_compress, SESSION, SEED)
    for s in (0, 5, 31):
        sent = b"".join(bytes(w.plan_x[c, s, :int(w.plan_n[c, s])].numpy())
                        for c in range(len(w.lens)))
        assert sent == w.plaintext(s, 0, len(sent))
        p = w.sent_before(w.calls, s)
        assert w.codec.history(s) == w.plaintext(s, p - 2047, p)


def test_full_session_mix_is_the_simple_imix():
    c = run.Cell(BENCH, SESSION)
    counts = dict((n, k) for n, k in c.traffic["packet_mix"])
    assert sum(counts.values()) == c.traffic["sessions"] == 8192
    assert counts[40] / counts[1500] == pytest.approx(7, rel=2e-3)
    assert counts[576] / counts[1500] == pytest.approx(4, rel=2e-3)
    assert sum(n * k for n, k in counts.items()) == 2_787_216
    assert c.config["codec"] == {"mtu": 1500, "window": 2047,
                                 "policy": "greedy"}


def test_sender_burst_follows_the_seed():
    a = _work(datagram_compress, SENDER, SEED)
    b = _work(datagram_compress, SENDER, SEED)
    c = _work(datagram_compress, SENDER, SEED + 1)
    assert a.payloads == b.payloads and a.payloads != c.payloads
    assert torch.equal(a.args[0], b.args[0])
    assert sorted(a.lens.tolist()) == sorted(c.lens.tolist())
    assert a.sizes == {"blocks": 24, "block": 1500,
                       "cap": lzs.cap_bytes(1500), "slots": 0}


def test_reference_round_trips_with_history():
    rng = np.random.default_rng(3)
    hist = bytes(rng.integers(97, 100, 3000, dtype=np.uint8))
    for packet in (b"", hist[-40:], hist[:700] + b"zz", hist[-2047:] * 2):
        stream = ref.compress_with_history(hist, packet)
        assert ref.decode_with_history(hist, stream) == (packet, 1)
    assert ref.compress_with_history(b"", b"abcabc") == lzs.compress_block(
        b"abcabc")


@pytest.mark.parametrize("stage", session_compress.STAGES)
def test_every_session_stage_has_a_work_model(stage):
    sizes = {"sessions": 8192, "live": 8192 * 2047 + 2_787_216,
             "kept": 8192 * 2047, "cap": lzs.cap_bytes(1500)}
    ops, nbytes = roofline_session.stage_work(stage, sizes)
    assert ops > 0 and nbytes > 0
    assert roofline_session.least_seconds(stage, sizes) > 0


def test_sender_stages_have_a_work_model():
    sizes = {"blocks": 8192, "block": 1500, "cap": lzs.cap_bytes(1500),
             "slots": 0}
    for stage in datagram_compress.STAGES:
        assert roofline.least_seconds(stage, sizes) > 0


def _span(name, ts, dur):
    return {"cat": "user_annotation", "name": name, "ts": ts, "dur": dur}


def _launch(corr, ts):
    return {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts,
            "dur": 1, "args": {"correlation": corr}}


def _device(corr, ts, dur):
    return {"cat": "kernel", "name": "k", "ts": ts, "dur": dur,
            "args": {"correlation": corr}}


def test_session_readers_on_a_canned_trace():
    """One call of 100 us: history 5-15 busy 10, candidates 20-60 busy
    30, history 70-80 busy 4."""
    events = [_span(tracing.CALL_SPAN, 0, 100), _span("lzs::history", 5, 10),
              _span("lzs::candidates", 20, 40), _span("lzs::history", 70, 10),
              _launch(1, 6), _launch(2, 21), _launch(3, 71),
              _device(1, 6, 10), _device(2, 25, 30), _device(3, 72, 4)]
    sizes = {"sessions": 4, "live": 4 * 3000, "kept": 4 * 2047,
             "cap": lzs.cap_bytes(1500)}
    r = run.Run(setup_s=1.0, calls=1, window_s=1.0, bytes_per_call=1,
                latencies=[0.1], sizes=sizes,
                stages=session_compress.STAGES,
                view=tracing.TraceView(events))
    assert run._reader("layer_metrics", "history_ms.session")(r) == (
        pytest.approx(0.014))
    least = sum(roofline_session.least_seconds(s, sizes)
                for s in session_compress.STAGES)
    assert run._reader("layer_metrics", "roofline_pct.session")(r) == (
        pytest.approx(100 * least / 44e-6))
    r.view = None
    for metric in ("history_ms.session", "roofline_pct.session"):
        assert run._reader("layer_metrics", metric)(r) is None


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [SESSION, SENDER])
def test_cell_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    line = run.run_cell(BENCH, cell, SEED, 0.5, False, device="cuda",
                        traffic=SMALL[cell])
    assert line["correct"] is True, line["checks"]
    assert set(line["metrics"]) == {"compress_gbps", "setup_s"}
