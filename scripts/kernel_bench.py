#!/usr/bin/env python3
"""Kernels of the port on their paths' own inputs: event, device, host and
cold-cache times, beside the plain version, the library call and the
kernel's bound.

Records every call of the named kernels' wrappers on the paths main,
raw and scan of ``chip_smoke.py`` (``chip_smoke.run_paths``: one greedy
compress + decompress of the frozen 8 MiB corpus and a second compress;
one ``decode_batch_raw`` of its raw per-block payload and one 2^18
``decode_block`` of a C-encoded slice; ``decode_batch(engine="scan")``
of the raw payload, whole and cut by a step budget). The first call of
each set of shapes is held bitwise to the plain version and timed on its
own tensors:

  event_ms       CUDA-event mean over --reps back-to-back calls (it
                 includes the host's launch cost wherever the host issues
                 slower than the card runs)
  device_ms      device kernel time per call (torch.profiler over --reps
                 calls: every kernel the call launched, nothing of the
                 host)
  host_us        host-clock time per call to issue --reps calls, the card
                 waited for only after the last
  host_parts_us  (kernel only) the same for two pieces of the wrapper's
                 host path: the device test (``_kernels.on_cpu``) and an
                 output's allocation (``torch.empty_like`` of the first
                 tensor); the rest of host_us is the operand checks, the
                 ctypes call and the launch
  cold_event_ms  (kernel only) CUDA-event time of one call issued right
                 after a --flush-mib MiB write that evicts the 50 MB L2,
                 mean over --reps such calls
  cold_device_ms (kernel only) the device time of the same calls, summed
                 over the kernels a warm call launches
  bound_ms       (kernel only) the least time of the call's function on an
                 H100: the larger of the bytes it must move over the memory
                 peak and its int32 operations over the int32 peak
                 (``chip_smoke.bound``: ``portbench/roofline.py``'s peaks
                 and ``OPS_PER_ELEMENT``, ``chip_smoke.OWN_OPS`` for the
                 kernels that table lacks), and ``bound_by``, which of
                 the two

for the kernel's wrapper ("kernel"), its plain torch version ("plain",
event time over --plain-reps calls, none where 0: the scan parse's
plain loop takes seconds a call) and, where one PyTorch call computes
the same function (``LIBRARY``), that call ("library"); event and
device time of a context call (``CONTEXT``: ext_fold's torch.cummax of
its prologue) where there is one ("context").

Run from the root of a checkout, on a machine with one CUDA device (to
compare two commits, run each tree's own copy):

    python3 scripts/kernel_bench.py [--kernels ext_fold parse]
        [--reps 50] [--plain-reps 3] [--flush-mib 256]

(the kernels default to the chained row scans: rowscan_rcummin,
rowscan_cummax and rowscan_cumsum; any key of ``WRAPPERS`` may be
named).

Prints the card's name and power limit, then one JSON line per shape.
Imports nothing of jax.
"""

from __future__ import annotations

import argparse
import functools
import hashlib
import json
import pathlib
import subprocess
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from bench import CORPUS_SHA, make_corpus  # noqa: E402
from chip_smoke import (  # noqa: E402
    BLOCK, SIZE, WRAPPERS, _as_tuple, _shape_key, bound, event_ms, run_paths)
from lzs_tpu_torch.blocks import BlockCodec  # noqa: E402
from lzs_tpu_torch.ops import _kernels, pext  # noqa: E402

#: the PyTorch call that computes a kernel's function, where there is one
#: (timed beside the kernel as a yardstick; the port never calls it): each
#: entry takes the call's arguments and returns the call, ready to time.
#: torch.gather takes int64 indices only, so gather_big's are widened
#: before the timing (the clamp is a no-op on the path's in-range indices).
#: No one PyTorch call computes the lane parse or ext_fold.
LIBRARY = {
    "rowscan_cummax": lambda v: functools.partial(torch.cummax, v, dim=1),
    "rowscan_rcummin": lambda v: lambda: torch.cummin(
        v.flip(1), dim=1).values.flip(1),
    "rowscan_cumsum": lambda v, tile=0: functools.partial(
        torch.cumsum, v, dim=1, dtype=torch.int32),
    "gather_big": lambda tab, idx: functools.partial(
        torch.gather, tab, 1, idx.clamp(0, tab.shape[1] - 1).long()),
}

#: a PyTorch call timed beside a kernel for context (not its library
#: call): ext_fold's scan alone, torch.cummax of the values its prologue
#: prepares, without the prologue's and epilogue's bytes
CONTEXT = {
    "ext_fold": ("torch.cummax of the prologue",
                 lambda packed, ext_h, score, cap: functools.partial(
                     torch.cummax, pext.fold_prologue(packed, ext_h, cap),
                     dim=1)),
}


def _kernel_events(fn, reps: int, before=None) -> list[dict]:
    """The device kernels of ``reps`` calls of fn (each after ``before()``
    where given), from the profiler's Chrome trace."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            if before is not None:
                before()
            fn()
        torch.cuda.synchronize()
    path = ROOT / "build" / "profile" / "kernel_bench.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    path.unlink()
    return [e for e in events if e.get("cat") == "kernel"]


def device_ms(fn, reps: int, before=None, names=None) -> float:
    """Device kernel ms per call; with ``names``, only those kernels."""
    fn()
    events = _kernel_events(fn, reps, before)
    total_us = sum(float(e["dur"]) for e in events
                   if names is None or e["name"] in names)
    if not total_us:
        raise SystemExit("the profiler saw no device kernels")
    return total_us / 1e3 / reps


def cold_event_ms(fn, reps: int, flush) -> float:
    """Mean CUDA-event ms of one call issued right after ``flush()``."""
    fn()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    total = 0.0
    for _ in range(reps):
        flush()
        t0.record()
        fn()
        t1.record()
        torch.cuda.synchronize()
        total += t0.elapsed_time(t1)
    return total / reps


def host_us(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / reps * 1e6


def record(kernels: list[str], data: bytes, device: torch.device) -> dict:
    """The recorded calls of ``kernels`` on the paths main, raw and scan
    (``chip_smoke.run_paths``), the first call of each set of shapes."""
    codec = BlockCodec(block=BLOCK, device=device)
    codec.decompress(codec.compress(data))            # build + warm up
    calls, _ = run_paths(("main", "raw", "scan"), data, device)
    picked = {}
    for path, by_kernel in calls.items():
        for name in kernels:
            for args, kw in by_kernel[name]:
                key = (name, path, _shape_key(args, kw))
                picked.setdefault(key, (args, kw))
    return picked


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels", nargs="+",
                    default=["rowscan_rcummin", "rowscan_cummax",
                             "rowscan_cumsum"])
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--plain-reps", type=int, default=3)
    ap.add_argument("--flush-mib", type=int, default=256)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_bench.py needs a CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)
    device = torch.device("cuda", 0)
    data = make_corpus(SIZE)
    if hashlib.sha256(data).hexdigest() != CORPUS_SHA:
        raise SystemExit("corpus drift")
    flush_buf = torch.empty(args.flush_mib << 20, dtype=torch.uint8,
                            device=device)

    def flush():
        flush_buf.fill_(1)

    for (name, path, shape), (a, kw) in record(args.kernels, data,
                                               device).items():
        module, attr, plain = WRAPPERS[name]
        wrapper = getattr(module, attr)

        def kernel():
            return wrapper(*a, **kw)

        got = _as_tuple(kernel())
        # gram_keys' key1 is None where the gram fits in key0
        if not all(g is w is None or torch.equal(g, w) for g, w in zip(
                got, _as_tuple(plain(*a, **kw)), strict=True)):
            raise SystemExit(f"{name} differs from plain at {shape}")
        names = {e["name"] for e in _kernel_events(kernel, 1)}
        first = next(t for t in a if torch.is_tensor(t))
        parts = {"on_cpu": lambda: _kernels.on_cpu(first),
                 "empty_like": lambda: torch.empty_like(first)}
        row = {"kernel_name": name, "path": path, "shape": shape,
               "kernel": {"event_ms": event_ms(kernel, args.reps),
                          "device_ms": device_ms(kernel, args.reps),
                          "host_us": host_us(kernel, args.reps),
                          "host_parts_us": {k: host_us(f, args.reps)
                                            for k, f in parts.items()},
                          "cold_event_ms": cold_event_ms(kernel, args.reps,
                                                         flush),
                          "cold_device_ms": device_ms(kernel, args.reps,
                                                      flush, names),
                          **bound(name, a, kw, got)},
               "plain": ({"event_ms": event_ms(lambda: plain(*a, **kw),
                                               args.plain_reps)}
                         if args.plain_reps > 0 else None)}
        library = LIBRARY.get(name)
        if library is not None:
            call = library(*a, **kw)
            row["library"] = {"event_ms": event_ms(call, args.reps),
                              "device_ms": device_ms(call, args.reps),
                              "host_us": host_us(call, args.reps)}
        if name in CONTEXT:
            label, context = CONTEXT[name]
            call = context(*a, **kw)
            row["context"] = {"call": label,
                              "event_ms": event_ms(call, args.reps),
                              "device_ms": device_ms(call, args.reps)}
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
