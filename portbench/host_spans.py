"""Host time of the compress call's framing, read from the program's
``lzs_host::<name>`` spans (``lzs_tpu_torch.trace.host``) in the traced
window: padding, copies, the container, and the host's waits for the
card. A span's time is the union of its intervals, so nested or
overlapping spans count once. A trace with no ``lzs_host::`` span at all
(a program without them) reads None; one without the spans read, 0 (the
distributed compress builds no container).
"""

from __future__ import annotations

from .tracing import merged

PREFIX = "lzs_host::"


def spans(view, names=None, but=()) -> list[tuple[float, float]]:
    """The union of the ``lzs_host::`` spans named in ``names`` (every
    one when None) and not in ``but``, clipped to the window, as disjoint
    sorted [start, end) intervals in us."""
    out = []
    for s, e, name in view.host_spans:
        if not name.startswith(PREFIX):
            continue
        short = name[len(PREFIX):]
        if (names is None or short in names) and short not in but:
            s, e = max(s, view.start), min(e, view.end)
            if e > s:
                out.append((s, e))
    return merged(out)


def intersect(a, b) -> list[tuple[float, float]]:
    """The intersection of two lists of disjoint sorted intervals."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if e > s:
            out.append((s, e))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def length(intervals) -> float:
    return sum(e - s for s, e in intervals)


def _traced(run) -> bool:
    """Whether the run has a trace that holds ``lzs_host::`` spans."""
    return run.view is not None and any(
        name.startswith(PREFIX) for _, _, name in run.view.host_spans)


def host_ms(run, names) -> float | None:
    """Host ms a traced call spends in the ``lzs_host::`` spans
    ``names``."""
    if not _traced(run):
        return None
    return length(spans(run.view, names)) / run.view.ncalls / 1e3


def idle_ms(run) -> float | None:
    """Device-idle ms a traced call while an ``lzs_host::`` span other
    than ``wait`` is open: the idle that the host's framing costs."""
    if not _traced(run):
        return None
    iv = spans(run.view, but=("wait",))
    busy = merged([(s, e) for s, e, _, _ in run.view.device])
    idle = length(iv) - length(intersect(iv, busy))
    return idle / run.view.ncalls / 1e3
