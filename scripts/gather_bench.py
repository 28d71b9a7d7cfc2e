#!/usr/bin/env python3
"""K10 ``gather_big`` against ``torch.gather``, device and host time apart.

Records the ``pgather.gather_big`` calls of one greedy compress of the
frozen 8 MiB corpus (``BlockCodec(block=32768, device="cuda")``: the
probe tier's span fetch, run column and delivery) and, on each recorded
call's own tensors, times the port's wrapper and ``torch.gather`` with
int64 indices, clamped into the table, made before the timing:

  event_ms   CUDA-event mean over --reps back-to-back calls, as
             chip_smoke.py times kernels (it includes the host's launch
             cost wherever the host launches slower than the card runs)
  device_ms  device kernel time per call, from torch.profiler over --reps
             calls (every kernel the call launched, nothing of the host)
  host_us    host-clock time per call to launch --reps calls, the card
             waited for only after the last (the launch path's cost)
  host_parts_us  the same for each piece of the wrapper's host path: the
             device test (``on_cpu``), one operand check, the output's
             allocation (``torch.empty`` with a shape, dtype and device,
             and ``torch.empty_like``), the current stream (as a
             ``torch.cuda.Stream`` and as the raw handle) and
             ``Kernel.launch`` (the ctypes call and the kernel launch) on
             a preallocated output

Run from the root of a checkout, on a machine with one CUDA device:

    python3 scripts/gather_bench.py [--reps 200] [--tree DIR]

``--tree DIR`` imports ``lzs_tpu_torch`` from DIR instead of this checkout
(an unpacked earlier commit, say), so two versions can be compared in one
call. Prints the card's name and power limit, then one JSON line.
Imports nothing of jax.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import pathlib
import subprocess
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
NAMES = {(8320, 26624): "spans", (32768, 1024): "run column",
         (1024, 32768): "delivery"}


def device_ms(fn, reps: int) -> float:
    """Summed device kernel time per call, from the profiler's trace."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    path = ROOT / "build" / "profile" / "gather_bench.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    path.unlink()
    total_us = sum(float(e["dur"]) for e in events
                   if e.get("cat") == "kernel")
    if not total_us:
        raise SystemExit("the profiler saw no device kernels")
    return total_us / 1e3 / reps


def event_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def host_us(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / reps * 1e6


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--tree", type=pathlib.Path, default=ROOT)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("gather_bench.py needs a CUDA device")
    tree = args.tree.resolve()
    sys.path.insert(0, str(tree))
    sys.path.insert(1, str(ROOT))
    from bench import CORPUS_SHA, make_corpus
    from lzs_tpu_torch.blocks import BlockCodec
    from lzs_tpu_torch.ops import _kernels, pgather

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)
    data = make_corpus(1 << 23)
    if hashlib.sha256(data).hexdigest() != CORPUS_SHA:
        raise SystemExit("corpus drift")
    codec = BlockCodec(block=1 << 15, device="cuda")
    codec.compress(data)                              # build + warm up
    calls = []
    wrapper = pgather.gather_big

    def record(tab, idx):
        calls.append((tab, idx))
        return wrapper(tab, idx)

    pgather.gather_big = record
    try:
        codec.compress(data)
    finally:
        pgather.gather_big = wrapper
    torch.cuda.synchronize()

    rows = []
    for tab, idx in calls:
        w, q = tab.shape[1], idx.shape[1]
        idx64 = idx.clamp(0, w - 1).long()
        fns = {"gather_big": lambda: pgather.gather_big(tab, idx),
               "torch.gather": lambda: torch.gather(tab, 1, idx64)}
        if not torch.equal(fns["gather_big"](), fns["torch.gather"]()):
            raise SystemExit(f"gather_big differs at W={w}, Q={q}")
        row = {"shape": NAMES.get((w, q), f"{w}x{q}"),
               "table": list(tab.shape), "queries": list(idx.shape)}
        for name, fn in fns.items():
            row[name] = {"event_ms": event_ms(fn, args.reps),
                         "device_ms": device_ms(fn, args.reps),
                         "host_us": host_us(fn, args.reps)}
        dev = tab.device
        out = torch.empty_like(idx)
        ptrs = (tab.data_ptr(), idx.data_ptr(), out.data_ptr(),
                tab.shape[0], w, q)
        parts = {
            "on_cpu": lambda: _kernels.on_cpu(tab, idx),
            "check": lambda: _kernels.check(idx, "idx", torch.int32),
            "empty": lambda: torch.empty((tab.shape[0], q),
                                         dtype=torch.int32, device=dev),
            "empty_like": lambda: torch.empty_like(idx),
            "current_stream": lambda: torch.cuda.current_stream(
                dev).cuda_stream,
            "raw_stream": lambda: torch._C._cuda_getCurrentRawStream(
                dev.index),
            "launch": lambda: _kernels.GATHER_BIG.launch(dev, *ptrs)}
        row["host_parts_us"] = {k: host_us(fn, args.reps)
                                for k, fn in parts.items()}
        rows.append(row)
    print(json.dumps({"tree": str(tree),
                      "device": torch.cuda.get_device_name(0),
                      "reps": args.reps, "calls": rows}), flush=True)


if __name__ == "__main__":
    main()
