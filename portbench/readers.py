"""What the metric files share: each ``end_to_end/<metric>.py`` and
``layer_metrics/<metric>.py`` defines ``read(run)``, which returns the
metric's value or None where the run holds nothing to read, and most of
them call one of these on the run's record (``run.Run``)."""

from __future__ import annotations

import statistics

from . import roofline


def rate_gbps(run) -> float:
    """GB (1e9 bytes) the window's calls completed, over the window."""
    return run.calls * run.bytes_per_call / run.window_s / 1e9


def p95_call_ms(run) -> float | None:
    """The 95th percentile of every call's latency in the untraced
    window."""
    if len(run.latencies) < 2:
        return None
    return statistics.quantiles(run.latencies, n=20)[18] * 1e3


def busy_ms_per_call(run, stages=None, name_prefix=None) -> float | None:
    """Device busy ms a traced call under ``stages`` (kernels named with
    ``name_prefix``), or None where the trace has none."""
    if run.view is None:
        return None
    busy = run.view.busy_s(stages, name_prefix)
    return busy / run.view.ncalls * 1e3 if busy > 0 else None


def framing_ms(run) -> float | None:
    """Host ms a traced call spends outside every ``lzs::`` stage."""
    if run.view is None:
        return None
    return run.view.host_outside_stages_s() / run.view.ncalls * 1e3


def roofline_pct(run) -> float | None:
    """The least time of the cell's stages over their device busy time,
    in percent."""
    if run.view is None:
        return None
    busy = run.view.busy_s(set(run.stages))
    if busy <= 0:
        return None
    least = sum(roofline.least_seconds(s, run.sizes) for s in run.stages)
    return 100.0 * least * run.view.ncalls / busy


def idle_pct(run) -> float | None:
    """The share of the traced window in which the device ran nothing."""
    if run.view is None:
        return None
    return 100.0 * (1.0 - run.view.busy_s() / run.view.window_s)
