#!/usr/bin/env python3
"""Kernels of the port on their paths' own inputs: event, device, host and
cold-cache times, beside the plain version and the library call.

Records every call of the named kernels' wrappers (``chip_smoke.py``'s
``recorded_calls``) in one greedy compress + decompress of the frozen
8 MiB corpus (path ``main``), one ``decode_batch_raw`` of its raw
per-block payload (``raw``), one 2^18 ``decode_block`` of a C-encoded
slice (``raw 2^18``) and one ``decode_batch(engine="scan")`` of the raw
payload (``scan``), and for the first call of each set of shapes times,
on that call's own tensors:

  event_ms       CUDA-event mean over --reps back-to-back calls, as
                 chip_smoke.py times kernels (it includes the host's
                 launch cost wherever the host issues slower than the card
                 runs)
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

for the kernel's wrapper ("kernel"), its plain torch version ("plain",
event time over --plain-reps calls, none where 0: the scan parse's
plain loop takes seconds a call) and, where one PyTorch call computes
the same function (chip_smoke.LIBRARY), that call ("library"); event and
device time of a context call (chip_smoke.CONTEXT: ext_fold's
torch.cummax of its prologue) where there is one ("context").

Run from the root of a checkout, on a machine with one CUDA device (an
earlier commit's tree runs its own copy of chip_smoke.py's helpers: copy
this script into its scripts/):

    python3 scripts/kernel_bench.py [--kernels ext_fold parse]
        [--reps 50] [--plain-reps 3] [--flush-mib 256]

(the kernels default to the chained row scans: rowscan_rcummin,
rowscan_cummax and rowscan_cumsum).

Prints the card's name and power limit, then one JSON line per shape.
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
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from bench import CORPUS_SHA, make_corpus  # noqa: E402
from lzs_tpu_torch.blocks import BlockCodec  # noqa: E402
from lzs_tpu_torch.ops import _kernels, bitpar, decode  # noqa: E402


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


def event_ms(fn, reps: int) -> float:
    return chip_smoke.cuda_ms(fn, reps)


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


def _as_tuple(out) -> tuple:
    return out if isinstance(out, tuple) else (out,)


def record(kernels: list[str], data: bytes, device: torch.device) -> dict:
    """The recorded calls of ``kernels`` per path, first call of each set
    of shapes (chip_smoke's paths and recorder)."""
    native_compress, _ = chip_smoke.native_codec()
    codec = BlockCodec(block=chip_smoke.BLOCK, device=device)
    codec.decompress(codec.compress(data))            # build + warm up
    calls = {}
    with chip_smoke.recorded_calls() as calls["main"]:
        codec.decompress(codec.compress(data))
    comp, clen, _, _ = chip_smoke.raw_payload(codec, data, device)
    with chip_smoke.recorded_calls() as calls["raw"]:
        codec.decode_batch_raw(comp, clen)
    with chip_smoke.recorded_calls() as calls["raw 2^18"]:
        decode.decode_bytes(native_compress(chip_smoke.wide_piece(data)),
                            bitpar.MAX_OUT_CAP, device=device)
    # absent from an earlier tree's chip_smoke.py and decode
    if "scan_parse" in chip_smoke.WRAPPERS:
        with chip_smoke.recorded_calls() as calls["scan"]:
            decode.decode_batch(comp, clen, out_cap=chip_smoke.BLOCK,
                                engine="scan")
    torch.cuda.synchronize()
    picked = {}
    for path, by_kernel in calls.items():
        for name in kernels:
            for args, kw in by_kernel[name]:
                key = (name, path, chip_smoke._shape_key(args, kw))
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
    data = make_corpus(chip_smoke.SIZE)
    if hashlib.sha256(data).hexdigest() != CORPUS_SHA:
        raise SystemExit("corpus drift")
    flush_buf = torch.empty(args.flush_mib << 20, dtype=torch.uint8,
                            device=device)

    def flush():
        flush_buf.fill_(1)

    for (name, path, shape), (a, kw) in record(args.kernels, data,
                                               device).items():
        module, attr, plain = chip_smoke.WRAPPERS[name]
        wrapper = getattr(module, attr)

        def kernel():
            return wrapper(*a, **kw)

        if not all(torch.equal(g, w) for g, w in zip(
                _as_tuple(kernel()), _as_tuple(plain(*a, **kw)),
                strict=True)):
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
                                                      flush, names)},
               "plain": ({"event_ms": event_ms(lambda: plain(*a, **kw),
                                               args.plain_reps)}
                         if args.plain_reps > 0 else None)}
        library = chip_smoke.LIBRARY.get(name)
        if library is not None:
            call = library(*a, **kw)
            row["library"] = {"event_ms": event_ms(call, args.reps),
                              "device_ms": device_ms(call, args.reps),
                              "host_us": host_us(call, args.reps)}
        # chip_smoke.CONTEXT is absent from an earlier tree's copy
        label, context = getattr(chip_smoke, "CONTEXT", {}).get(
            name, (None, None))
        if context is not None:
            call = context(*a, **kw)
            row["context"] = {"call": label,
                              "event_ms": event_ms(call, args.reps),
                              "device_ms": device_ms(call, args.reps)}
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
