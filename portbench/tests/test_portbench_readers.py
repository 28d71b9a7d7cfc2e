"""The trace view and the metric readers on a canned profiler trace."""

from __future__ import annotations

import pytest

from portbench import roofline, run, tracing


def _span(name, ts, dur):
    return {"cat": "user_annotation", "name": name, "ts": ts, "dur": dur}


def _launch(corr, ts):
    return {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts,
            "dur": 1, "args": {"correlation": corr}}


def _device(corr, ts, dur, name="k", cat="kernel"):
    return {"cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": {"correlation": corr}}


#: two calls of 100 us; device busy 20-50 (candidates), 55-65 (pack),
#: 80-90 (a copy outside the stages), 220-260 (candidates), 280-290 (an
#: nccl kernel launched outside the stages)
EVENTS = [
    _span(tracing.CALL_SPAN, 0, 100), _span(tracing.CALL_SPAN, 200, 100),
    _span("lzs::candidates", 10, 30), _span("lzs::pack", 50, 10),
    _span("lzs::candidates", 210, 30),
    _launch(1, 15), _launch(2, 55), _launch(3, 70), _launch(4, 215),
    _launch(5, 90),
    _device(1, 20, 30), _device(2, 55, 10),
    _device(3, 80, 10, "Memcpy DtoH", "gpu_memcpy"),
    _device(4, 220, 40), _device(5, 280, 10, "ncclDevKernel_AllGather"),
    {"cat": "cpu_op", "name": "aten::add", "ts": 12, "dur": 2},
]


@pytest.fixture
def traced():
    view = tracing.TraceView(EVENTS)
    sizes = {"blocks": 4, "block": 32768, "cap": 36876, "slots": 145,
             "span": 2048}
    return run.Run(setup_s=1.5, calls=2, window_s=0.5, bytes_per_call=10**9,
                   latencies=[0.01 * i for i in range(1, 101)],
                   sizes=sizes, stages=("candidates", "pack"), view=view)


def test_view_window_and_busy(traced):
    v = traced.view
    assert v.ncalls == 2
    assert v.window_s == pytest.approx(300e-6)
    assert v.busy_s() == pytest.approx(100e-6)
    assert v.busy_s({"candidates"}) == pytest.approx(70e-6)
    assert v.busy_s({"pack"}) == pytest.approx(10e-6)
    assert v.busy_s(name_prefix="nccl") == pytest.approx(10e-6)
    assert v.host_outside_stages_s() == pytest.approx(130e-6)


def test_view_breakdown(traced):
    v = traced.view
    ops = dict(v.top_device_ops())
    assert ops["k"] == pytest.approx(80e-6)
    gaps = v.idle_gaps()
    assert gaps[0] == [tracing.CALL_SPAN, pytest.approx(130e-6)]
    assert len(gaps) == 6
    assert sum(g for _, g in gaps) == pytest.approx(200e-6)


@pytest.mark.parametrize("metric,want", [
    ("match_search_ms", 0.035), ("emit_ms", 0.005),
    ("framing_ms.compress", 0.065), ("nccl_ms.compress", 0.005),
    ("idle_pct.compress", 100 * 2 / 3), ("idle_pct.raw", 100 * 2 / 3),
    ("idle_pct.decompress", 100 * 2 / 3),
])
def test_layer_readers(traced, metric, want):
    assert run._reader("layer_metrics", metric)(traced) == pytest.approx(
        want)


@pytest.mark.parametrize("metric", ["container_decode_ms", "raw_heads_ms",
                                    "raw_walk_expand_ms"])
def test_readers_with_nothing_to_read_return_none(traced, metric):
    assert run._reader("layer_metrics", metric)(traced) is None


def test_readers_without_a_trace_return_none(traced):
    traced.view = None
    for metric in ("match_search_ms", "framing_ms.compress",
                   "roofline_pct.compress", "idle_pct.compress"):
        assert run._reader("layer_metrics", metric)(traced) is None


def test_roofline_share(traced):
    least = (roofline.least_seconds("candidates", traced.sizes)
             + roofline.least_seconds("pack", traced.sizes))
    got = run._reader("layer_metrics", "roofline_pct.compress")(traced)
    assert got == pytest.approx(100 * least * 2 / 80e-6)


@pytest.mark.parametrize("metric", ["p95_call_ms.compress",
                                    "p95_call_ms.decompress",
                                    "p95_call_ms.raw"])
def test_p95_reads_every_call(traced, metric):
    assert run._reader("layer_metrics", metric)(traced) == pytest.approx(
        959.5)  # statistics.quantiles, its exclusive method


def test_end_to_end_readers(traced):
    assert run._reader("end_to_end", "setup_s")(traced) == 1.5
    for m in ("compress_gbps", "decompress_gbps", "raw_decode_gbps"):
        assert run._reader("end_to_end", m)(traced) == pytest.approx(4.0)


@pytest.mark.parametrize("stage", ["candidates", "extend", "units", "pack",
                                   "sync", "parse", "fill", "expand",
                                   "heads", "walk", "records", "raw_fill",
                                   "raw_expand"])
def test_every_stage_has_a_work_model(stage):
    sizes = {"blocks": 1024, "block": 32768, "cap": 36876, "slots": 145,
             "lanes": 1024 * 80, "span": 2048, "streams": 8192,
             "in_bytes": 3_000_000, "out_bytes": 6_068_264}
    ops, nbytes = roofline.stage_work(stage, sizes)
    assert ops > 0 and nbytes > 0
    assert roofline.least_seconds(stage, sizes) > 0


def test_trace_without_device_activity_is_refused():
    with pytest.raises(RuntimeError):
        tracing.TraceView([e for e in EVENTS if e["cat"] not in (
            "kernel", "gpu_memcpy")])
