"""The traced window: a ``torch.profiler`` trace of the entry's calls and
what the per-layer readers take from it.

Device activity (kernels, copies, sets) is attributed to the program's
``lzs::<stage>`` span (``lzs_tpu_torch.trace.stage``) that was open on the
host when the activity was launched, and busy time is the union of the
activity intervals, so overlapping activities count once; both are
copies of ``scripts/profile_port.py`` (``_union_us``, ``device_summary``).
The harness wraps each call in a ``portbench::call`` span: the traced
window runs from the first call's start to the last call's end.
"""

from __future__ import annotations

import bisect
import collections
import json
import os
import pathlib
import tempfile

import torch

CALL_SPAN = "portbench::call"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def union_us(intervals) -> float:
    """Total length of the union of [start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def merged(intervals) -> list[tuple[float, float]]:
    """The union of [start, end) intervals as disjoint sorted intervals."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def record(loop) -> list[dict]:
    """Run ``loop()`` under the profiler (host and device activity) and
    return the Chrome trace's events. The trace file lives in a temporary
    directory and is deleted once read."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        loop()
    with tempfile.TemporaryDirectory(prefix="portbench-") as tmp:
        path = pathlib.Path(tmp) / "trace.json"
        prof.export_chrome_trace(os.fspath(path))
        return json.loads(path.read_text())["traceEvents"]


class TraceView:
    """The traced window of one process: calls, stages and device time."""

    def __init__(self, events: list[dict]):
        spans = [e for e in events if e.get("cat") == "user_annotation"
                 and "dur" in e]
        self.calls = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                            for e in spans if e.get("name") == CALL_SPAN)
        if not self.calls:
            raise RuntimeError("the trace holds no call span")
        self.start, self.end = self.calls[0][0], self.calls[-1][1]
        self.stages = sorted(
            (float(e["ts"]), float(e["ts"]) + float(e["dur"]),
             e["name"][len("lzs::"):]) for e in spans
            if e.get("name", "").startswith("lzs::"))
        self._stage_starts = [s for s, _, _ in self.stages]
        launch_ts = {e["args"]["correlation"]: float(e["ts"])
                     for e in events if e.get("cat") in _LAUNCH_CATS
                     and "correlation" in e.get("args", {})}
        #: (start us, end us, name, stage) of each device activity in the
        #: window, clipped to it
        self.device = []
        for e in events:
            if e.get("cat") not in _DEVICE_CATS:
                continue
            s = max(float(e["ts"]), self.start)
            t = min(float(e["ts"]) + float(e["dur"]), self.end)
            if t <= s:
                continue
            launch = launch_ts.get(e.get("args", {}).get("correlation"))
            self.device.append((s, t, e.get("name", ""),
                                self.stage_at(launch)))
        if not self.device:
            raise RuntimeError("the trace holds no device activity in its "
                               "window")
        self.host_spans = sorted(
            (float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
            for e in spans)

    @property
    def ncalls(self) -> int:
        return len(self.calls)

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e6

    def stage_at(self, ts: float | None) -> str | None:
        """The innermost ``lzs::`` stage open on the host at ``ts`` (the
        latest started of up to four nested ones), or None."""
        if ts is None:
            return None
        k = bisect.bisect_right(self._stage_starts, ts) - 1
        for j in range(k, max(k - 4, -1), -1):
            s, e, name = self.stages[j]
            if s <= ts < e:
                return name
        return None

    def busy_s(self, stages=None, name_prefix: str | None = None) -> float:
        """Seconds in which the device ran activity of ``stages`` (all
        when None) and, where given, of a name with ``name_prefix``."""
        iv = [(s, e) for s, e, name, st in self.device
              if (stages is None or st in stages)
              and (name_prefix is None or name.startswith(name_prefix))]
        return union_us(iv) / 1e6

    def host_outside_stages_s(self) -> float:
        """Host seconds of the calls outside every ``lzs::`` span."""
        total = 0.0
        for cs, ce in self.calls:
            inner = [(max(s, cs), min(e, ce)) for s, e, _ in self.stages
                     if s < ce and e > cs]
            total += (ce - cs) - union_us(inner)
        return total / 1e6

    def top_device_ops(self, k: int = 10) -> list[list]:
        """The ``k`` device activities with the most summed seconds."""
        by_name = collections.Counter()
        for s, e, name, _ in self.device:
            by_name[name[:120]] += (e - s) / 1e6
        return [[name, sec] for name, sec in by_name.most_common(k)]

    def idle_gaps(self, k: int = 10) -> list[list]:
        """The ``k`` longest idle gaps of the device in the window, each
        named by the innermost host span open where it begins."""
        busy = merged([(s, e) for s, e, _, _ in self.device])
        edges = [self.start] + [x for iv in busy for x in iv] + [self.end]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for s, e in gaps[:k]:
            open_ = [name for hs, he, name in self.host_spans
                     if hs <= s < he]
            out.append([open_[-1] if open_ else "between calls",
                        (e - s) / 1e6])
        return out
