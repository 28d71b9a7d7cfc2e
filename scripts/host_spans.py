#!/usr/bin/env python3
"""Where the compress call's host time goes, read from the program's
``lzs_host::`` spans (``lzs_tpu_torch.trace.host``) on the card.

    python3 scripts/host_spans.py split --workload <cell> --seed <n> \
        [--seconds 20]
    python3 scripts/host_spans.py syncs [--seed <n>]
    python3 scripts/host_spans.py cost [--spans 100000]

``split`` runs one traced run of a benchmark cell (``portbench.run``) and
prints, as one JSON line, the result's metrics and from (rank 0's)
traced window, in ms a call: each host span's time; ``wait`` inside and
outside the stages; ``framing_ms`` (the call outside every ``lzs::``
stage) and the share of it that the host spans outside the stages
cover; the device-idle time in the calls, under each host span, under
the stages and under no program span at all; and the median call of the
traced and of the untraced window.

``syncs`` calls each benchmark cell's entry once, at the cell's size and
warm, under ``torch.cuda.set_sync_debug_mode("warn")``, and prints every
call that synchronised, by the line of this repository that made it,
with its count in the call. The distributed compress runs on a world of
one card (the same code as on four).

``cost`` times ``--spans`` empty ``trace.host`` spans with no profiler
running and prints the microseconds of one.

Run from the root of a checkout on a machine with a CUDA card. Imports
nothing of jax.
"""

from __future__ import annotations

import argparse
import collections
import importlib
import json
import pathlib
import statistics
import sys
import time
import traceback
import warnings

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from portbench import host_spans, run, tracing  # noqa: E402
from portbench.tracing import merged  # noqa: E402
from portbench.host_spans import intersect, length  # noqa: E402

SYNC_CELLS = ("container-32k.compress", "container-32k.decompress",
              "ipcomp-1500.raw-decode", "container-32k.compress-x4")


def _bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _without(a, b) -> list[tuple[float, float]]:
    """The intervals of ``a`` less those of ``b`` (both disjoint and
    sorted)."""
    if not a:
        return []
    lo, hi = a[0][0], a[-1][1]
    edges = [lo] + [x for s, e in b for x in (s, e)] + [hi]
    rest = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    return intersect(a, rest)


def split(view, latencies) -> dict:
    """The host spans' split of rank 0's traced calls, in ms a call."""
    per = 1e3 * view.ncalls
    names = sorted({n[len(host_spans.PREFIX):] for _, _, n
                    in view.host_spans if n.startswith(host_spans.PREFIX)})
    stages = merged([(s, e) for s, e, _ in view.stages])
    program = merged(stages + host_spans.spans(view))
    calls = merged(view.calls)
    busy = merged([(s, e) for s, e, _, _ in view.device])
    idle = _without(calls, busy)
    wait = host_spans.spans(view, ("wait",))
    wait_out = length(_without(wait, stages)) / per
    spans = {n: length(host_spans.spans(view, (n,))) / per for n in names}
    framing = view.host_outside_stages_s() * 1e3 / view.ncalls
    covered = length(_without(host_spans.spans(view, but=("wait",)),
                              stages)) / per + wait_out
    idle_none = length(_without(idle, program)) / per
    idle_all = length(idle) / per
    return {
        "calls": view.ncalls,
        "host_ms": spans,
        "wait_inside_stages_ms": spans.get("wait", 0.0) - wait_out,
        "wait_outside_stages_ms": wait_out,
        "framing_ms": framing,
        "spans_outside_stages_ms": covered,
        "spans_over_framing_pct": 100 * covered / framing,
        "idle_in_calls_ms": idle_all,
        "idle_under_ms": {n: length(intersect(
            idle, host_spans.spans(view, (n,)))) / per for n in names},
        "idle_under_stages_ms": length(intersect(idle, stages)) / per,
        "idle_under_no_span_ms": idle_none,
        "idle_under_no_span_pct": 100 * idle_none / idle_all,
        "median_call_ms": {
            "traced": statistics.median(e - s for s, e in view.calls) / 1e3,
            "untraced": statistics.median(latencies) * 1e3},
    }


def cmd_split(args) -> dict:
    caught = {}

    class View(tracing.TraceView):
        def __init__(self, events):
            super().__init__(events)
            caught["view"] = self

    class Run(run.Run):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            caught["run"] = self

    tracing.TraceView, run.Run = View, Run
    line = run.run_cell(_bench(), args.workload, args.seed, args.seconds,
                        True)
    return {"workload": args.workload, "seed": args.seed,
            "correct": line["correct"],
            "metrics": {k: v["value"] for k, v in line["metrics"].items()},
            "idle_gaps": line["breakdown"]["idle_gaps"],
            **split(caught["view"], caught["run"].latencies)}


def _repo_frame(stack) -> str:
    """``file:line (function)`` of the innermost frame of this
    repository's program (not of this script), or else of the innermost
    frame outside the warnings machinery."""
    for f in reversed(stack):
        path = pathlib.Path(f.filename)
        if ROOT in path.parents and path.name != "host_spans.py":
            return f"{path.relative_to(ROOT)}:{f.lineno} ({f.name})"
    inner = [f for f in stack if not f.filename.endswith("warnings.py")]
    f = inner[-1]
    return f"outside the program: {f.filename}:{f.lineno} ({f.name})"


def sync_points(fn) -> collections.Counter:
    """The synchronising calls of ``fn()``, counted by the line that
    made them."""
    seen = collections.Counter()

    def note(message, category, *rest, **kw):
        if "synchroniz" in str(message):
            seen[_repo_frame(traceback.extract_stack()[:-1])] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = note
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return seen


def cmd_syncs(args) -> dict:
    bench = _bench()
    out = {}
    for name in SYNC_CELLS:
        cell = run.Cell(bench, name)
        if cell.traffic["driver"] == "dist_compress":
            cell.traffic.update(world=1, file_bytes=1 << 25)
        driver = importlib.import_module(
            f"portbench.drivers.{cell.traffic['driver']}")
        work = driver.setup(cell.config["codec"], cell.traffic, args.seed,
                            "cuda")
        try:
            for _ in range(cell.traffic["warm_calls"]):
                work.call()
            torch.cuda.synchronize()
            out[name] = dict(sync_points(work.call))
            if hasattr(work, "end_phase"):
                work.end_phase()
        finally:
            work.close()
    return out


def cmd_cost(args) -> dict:
    from lzs_tpu_torch import trace

    def loop():
        t0 = time.perf_counter()
        for _ in range(args.spans):
            with trace.host("wait"):
                pass
        return (time.perf_counter() - t0) / args.spans * 1e6

    loop()  # warm
    return {"spans": args.spans, "host_span_us": [loop() for _ in range(3)]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("split")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    p = sub.add_parser("syncs")
    p.add_argument("--seed", type=int, default=2**31 + 7)
    p = sub.add_parser("cost")
    p.add_argument("--spans", type=int, default=100_000)
    args = ap.parse_args(argv)
    out = {"split": cmd_split, "syncs": cmd_syncs, "cost": cmd_cost}[
        args.cmd](args)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
