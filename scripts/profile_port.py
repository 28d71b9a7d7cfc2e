#!/usr/bin/env python3
"""Device busy time and idle share of the PyTorch/CUDA port's codec.

Runs ``lzs_tpu_torch.BlockCodec(block=32768, device="cuda")`` on the frozen
8 MiB corpus (``bench.make_corpus``): first ``--reps`` unprofiled
compress, decompress, raw-decode (``decode_batch_raw`` of the codec's
own per-block raw payload, engine "bits") and scan-decode (the same
payload through ``ops.decode.decode_batch(engine="scan")``) calls
(host-clock wall, median), then
one call of each under ``torch.profiler``. From the profiler's Chrome trace it
keeps only device activities (kernels, memcpy, memset), never the host
ops that launched them, and merges overlapping intervals, so a parent op
and its kernels are not counted twice. It prints, per call:

  wall_ms       unprofiled walls (median and range) and the profiled wall
  busy_ms       union of the device activity intervals
  idle          1 - busy / wall, against the profiled and median walls
  stages        busy ms per pipeline stage: an activity belongs to the
                ``lzs::<stage>`` span (lzs_tpu_torch.trace: STAGES, and
                RAW_STAGES and SCAN_STAGES for the raw decode's two
                engines) that was open on the host
                when it was launched; "other" is the rest
  top           the device activities with the most summed time
  port_kernels  each of the port's own CUDA kernels (lzs_tpu_torch/csrc):
                launches, summed device ms and device ms per launch

Run from the root of a checkout, on a machine with one CUDA device:

    python3 scripts/profile_port.py [--reps 5]

The trace is written under build/profile/ and deleted after reading.
Imports nothing of jax.
"""

from __future__ import annotations

import argparse
import collections
import hashlib
import json
import pathlib
import re
import statistics
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from bench import CORPUS_SHA, make_corpus  # noqa: E402
from lzs_tpu_torch import BlockCodec  # noqa: E402
from lzs_tpu_torch.blocks import pad_blocks  # noqa: E402
from lzs_tpu_torch.ops import decode  # noqa: E402

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
#: the __global__ functions of lzs_tpu_torch/csrc (each opens a line)
_PORT_KERNELS = frozenset(
    name for src in (ROOT / "lzs_tpu_torch" / "csrc").glob("*.cu*")
    for name in re.findall(r"^(\w+_kernel)\(", src.read_text(), re.M))


def _union_us(intervals: list[tuple[float, float]]) -> float:
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


def device_summary(events: list[dict]) -> dict:
    """Busy time, activity count, per-stage busy and top activities of
    one Chrome trace's events."""
    device = [e for e in events if e.get("cat") in _DEVICE_CATS]
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in events
                 if e.get("cat") in _LAUNCH_CATS
                 and "correlation" in e.get("args", {})}
    spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"][len("lzs::"):])
                   for e in events if e.get("cat") == "user_annotation"
                   and e.get("name", "").startswith("lzs::"))

    def stage_of(ev: dict) -> str:
        t = launch_ts.get(ev.get("args", {}).get("correlation"))
        if t is None:
            return "other"
        for s, e, name in spans:
            if s <= t < e:
                return name
        return "other"

    by_stage = collections.defaultdict(list)
    by_name = collections.Counter()
    port = collections.defaultdict(lambda: [0, 0.0])
    for ev in device:
        iv = (float(ev["ts"]), float(ev["ts"]) + float(ev["dur"]))
        by_stage[stage_of(ev)].append(iv)
        by_name[ev["name"][:60]] += float(ev["dur"])
        name = re.sub(r"^(void )?(\w+::)*", "", ev["name"].replace(
            "(anonymous namespace)::", "")).split("(")[0]
        if name.split("<")[0] in _PORT_KERNELS:
            port[name][0] += 1
            port[name][1] += float(ev["dur"])
    all_iv = [iv for ivs in by_stage.values() for iv in ivs]
    return {
        "busy_ms": _union_us(all_iv) / 1e3,
        "activities": len(device),
        "stages": {k: round(_union_us(v) / 1e3, 4)
                   for k, v in sorted(by_stage.items())},
        "top": [[name, round(us / 1e3, 4)]
                for name, us in by_name.most_common(8)],
        "port_kernels": {k: {"launches": c, "ms": round(us / 1e3, 4),
                             "ms_per_launch": round(us / 1e3 / c, 4)}
                         for k, (c, us) in sorted(port.items())},
    }


def _wall(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def profile_call(name: str, fn, reps: int, trace_dir: pathlib.Path) -> dict:
    walls = [_wall(fn) for _ in range(reps)]
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        prof_wall = _wall(fn)
    path = trace_dir / f"{name}.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    path.unlink()
    out = device_summary(events)
    median = statistics.median(walls)
    out.update({
        "wall_ms": {"median": median, "min": min(walls), "max": max(walls),
                    "profiled": prof_wall},
        "idle_of_profiled": 1 - out["busy_ms"] / prof_wall,
        "idle_of_median": 1 - out["busy_ms"] / median,
    })
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_port.py needs a CUDA device")
    data = make_corpus(1 << 23)
    if hashlib.sha256(data).hexdigest() != CORPUS_SHA:
        raise SystemExit("corpus drift")
    codec = BlockCodec(block=1 << 15, device="cuda")
    blob = codec.compress(data)                     # build + warm up
    if codec.decompress(blob) != data:
        raise SystemExit("round trip differs")
    x, lens = pad_blocks(data, codec.block)
    comp, clen, _, _, _ = codec.encode_batch(
        torch.from_numpy(x).cuda(), torch.from_numpy(lens).cuda())
    _, out_len, _ = codec.decode_batch_raw(comp, clen)
    if out_len.tolist() != lens.tolist():
        raise SystemExit("raw decode lengths differ")

    def scan():
        return decode.decode_batch(comp, clen, out_cap=codec.block,
                                   engine="scan")

    if scan()[1].tolist() != lens.tolist():
        raise SystemExit("scan decode lengths differ")
    trace_dir = ROOT / "build" / "profile"
    trace_dir.mkdir(parents=True, exist_ok=True)
    result = {
        "device": torch.cuda.get_device_name(0),
        "compress": profile_call("compress", lambda: codec.compress(data),
                                 args.reps, trace_dir),
        "decompress": profile_call("decompress",
                                   lambda: codec.decompress(blob),
                                   args.reps, trace_dir),
        "raw_decode": profile_call(
            "raw_decode", lambda: codec.decode_batch_raw(comp, clen),
            args.reps, trace_dir),
        "scan_decode": profile_call("scan_decode", scan, args.reps,
                                    trace_dir),
    }
    print(json.dumps(result, indent=1), flush=True)


if __name__ == "__main__":
    main()
