"""The host-span readers (``portbench/host_spans.py`` and the five
``host_*_ms.compress`` metrics) on a canned profiler trace."""

from __future__ import annotations

import pytest

from portbench import host_spans, run, tracing
from test_portbench_readers import _device, _launch, _span


def _call(t0, corr, nested_wait="lzs_host::wait", container=True):
    """One compress call of 200 us from ``t0``: pad 0-40 (the card idle),
    copy_in 40-60 (a copy 45-60), extend 60-120 (a kernel 65-100, then a
    wait 100-115 inside it with the card idle), a wait 120-130 outside
    the stages (a kernel 120-128), copy_out 130-150 (a copy 130-150),
    container 150-195 (the card idle)."""
    ev = [_span(tracing.CALL_SPAN, t0, 200),
          _span("lzs_host::pad", t0, 40),
          _span("lzs_host::copy_in", t0 + 40, 20),
          _span("lzs::extend", t0 + 60, 60),
          _span(nested_wait, t0 + 100, 15),
          _span("lzs_host::wait", t0 + 120, 10),
          _span("lzs_host::copy_out", t0 + 130, 20)]
    if container:
        ev.append(_span("lzs_host::container", t0 + 150, 45))
    for k, (launch, ts, dur, cat) in enumerate([
            (41, 45, 15, "gpu_memcpy"), (62, 65, 35, "kernel"),
            (121, 120, 8, "kernel"), (130, 130, 20, "gpu_memcpy")]):
        ev += [_launch(corr + k, t0 + launch),
               _device(corr + k, t0 + ts, dur, cat=cat)]
    return ev


def _run(events):
    return run.Run(setup_s=1.0, calls=2, window_s=0.5, bytes_per_call=1,
                   latencies=[0.1, 0.2], sizes={}, stages=("extend",),
                   view=tracing.TraceView(events))


@pytest.fixture
def traced():
    return _run(_call(0, 1) + _call(300, 11))


@pytest.mark.parametrize("metric,want", [
    ("host_pad_ms.compress", 0.040),
    ("host_copy_ms.compress", 0.040),      # copy_in and copy_out
    ("host_container_ms.compress", 0.045),
    ("host_wait_ms.compress", 0.025),      # inside extend and outside
    ("host_idle_ms.compress", 0.090),      # 40 + 5 + 45 us a call
])
def test_host_readers(traced, metric, want):
    assert run._reader("layer_metrics", metric)(traced) == pytest.approx(
        want)


def test_idle_leaves_out_a_wait_inside_a_stage(traced):
    # the card is idle for 15 us under the wait nested in extend; named
    # as framing, the same gap counts
    framed = _run(_call(0, 1, nested_wait="lzs_host::container")
                  + _call(300, 11, nested_wait="lzs_host::container"))
    assert host_spans.idle_ms(traced) == pytest.approx(0.090)
    assert host_spans.idle_ms(framed) == pytest.approx(0.105)


def test_idle_counts_a_gap_under_pad():
    events = [_span(tracing.CALL_SPAN, 0, 100),
              _span("lzs_host::pad", 10, 50),
              _launch(1, 60), _device(1, 70, 20)]
    got = host_spans.idle_ms(_run(events))
    assert got == pytest.approx(0.050)


def test_spans_do_not_move_the_stage_attribution(traced):
    view = traced.view
    assert [name for _, _, name in view.stages] == ["extend", "extend"]
    assert view.busy_s({"extend"}) == pytest.approx(70e-6)
    # 200 - 60 us of each call lies outside the stage
    assert run._reader("layer_metrics", "framing_ms.compress")(
        traced) == pytest.approx(0.140)
    # each gap is named by the innermost span open where it starts
    gaps = {round(g * 1e6): name for name, g in view.idle_gaps()}
    assert gaps[195] == gaps[50] == "lzs_host::container"
    assert gaps[20] == "lzs_host::wait"       # nested in extend


def test_a_compress_without_a_container_reads_zero():
    r = _run(_call(0, 1, container=False) + _call(300, 11, container=False))
    assert host_spans.host_ms(r, ("container",)) == 0.0
    assert host_spans.host_ms(r, ("pad",)) == pytest.approx(0.040)


@pytest.mark.parametrize("metric", [
    "host_pad_ms.compress", "host_copy_ms.compress",
    "host_container_ms.compress", "host_wait_ms.compress",
    "host_idle_ms.compress"])
def test_a_trace_without_host_spans_reads_none(traced, metric):
    bare = _run([e for e in _call(0, 1) + _call(300, 11)
                 if not e["name"].startswith(host_spans.PREFIX)])
    assert run._reader("layer_metrics", metric)(bare) is None
    traced.view = None
    assert run._reader("layer_metrics", metric)(traced) is None


@pytest.mark.parametrize("a,b,want", [
    ([], [(0, 1)], []),
    ([(0, 10)], [(2, 3), (5, 12)], [(2, 3), (5, 10)]),
    ([(0, 2), (4, 6)], [(1, 5)], [(1, 2), (4, 5)]),
    ([(0, 1)], [(1, 2)], []),
])
def test_intersect(a, b, want):
    assert host_spans.intersect(a, b) == want
