"""Run one cell of the port's benchmark once.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``. The cell names
a configuration (``portbench/configs/<config>.json``) and a traffic mix
(``portbench/traffic/<traffic>.json``); the mix names its driver
(``portbench/drivers/<driver>.py``), which makes the inputs from the seed
and calls the entry under test. Set-up (imports, inputs, the kernel
library's build or load, the warm-up calls) ends where the window
starts. One client calls the entry back to back for ``--seconds``
(a closed loop); each call ends with its result complete. With
``--trace 1`` a traced window follows (``trace_seconds`` of the mix, at
most ``--seconds``), and the run reports the per-layer metrics
(``portbench/layer_metrics/<metric>.py``) in place of the end-to-end ones
(``portbench/end_to_end/<metric>.py``).

After the window the kept results (a sample of the calls drawn from the
seed) are compared with the plain reference, and each number compared is
printed with its limit as the last lines of standard error and under
``checks``, the last key of the result: the JSON object that is the last
line of standard output. Without a CUDA card, or with fewer cards than
the cell asks for, the run exits with an error and prints no result; so
it does if a JAX module was loaded.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from . import tracing  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
#: top-level module names that may not be loaded in a run: JAX and the
#: JAX package (a whole name: ``lzs_tpu_torch`` is the program)
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "lzs_tpu"})


@dataclasses.dataclass
class Run:
    """What a run measured: the metric readers' input."""
    setup_s: float
    calls: int
    window_s: float
    bytes_per_call: int
    latencies: list
    sizes: dict
    stages: tuple
    view: tracing.TraceView | None = None


class Cell:
    """One entry of ``workloads`` with its configuration, traffic and
    metrics, read from the benchmark's files."""

    def __init__(self, bench: dict, name: str):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
        self.spec = cells[name]
        self.name = name
        self.chips = self.spec["chips"]
        cfg = next(c for c in bench["configs"]
                   if c["name"] == self.spec["config"])
        self.config = json.loads((HERE.parent / cfg["file"]).read_text())
        self.traffic = json.loads(
            (HERE / "traffic" / f"{self.spec['traffic']}.json").read_text())
        e2e = [m for m in bench["end_to_end"] if self._has(m)]
        reported = {m["name"] for m in e2e}
        self.end_to_end = [m["name"] for m in e2e]
        layer = [m for m in bench["per_layer"]
                 if m["moves"] in reported and self._has(m)]
        self.per_layer = [m["name"] for m in layer]
        self.units = {m["name"]: m["unit"] for m in e2e + layer}

    def _has(self, metric: dict) -> bool:
        return "workloads" not in metric or self.name in metric["workloads"]


def forbidden_loaded() -> list[str]:
    """JAX modules (by whole top-level name) in this process."""
    return sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)


def _reader(folder: str, metric: str):
    """``read`` of ``portbench/<folder>/<metric>.py`` (names hold dots, so
    the file is loaded by its path)."""
    path = HERE / folder / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.{folder}.{metric.replace('.', '__')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _power_limit_w() -> float | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30, check=True).stdout
        return float(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


class _Keep:
    """A sample of the window's results, drawn from the seed (reservoir
    sampling: every call is kept with the same chance)."""

    def __init__(self, k: int, rng: np.random.Generator):
        self.k, self.rng, self.kept = k, rng, []

    def offer(self, index: int, result) -> None:
        if index < self.k:
            self.kept.append((index, result))
            return
        j = int(self.rng.integers(0, index + 1))
        if j < self.k:
            self.kept[j] = (index, result)


def _loop(work, seconds: float, keep: _Keep | None = None):
    """Call the entry back to back for ``seconds``: (calls, window
    seconds, latencies, failed)."""
    lat = []
    failed = 0
    start = time.perf_counter()
    deadline = start + seconds
    end = start
    while end < deadline:
        t0 = time.perf_counter()
        try:
            with torch.profiler.record_function(tracing.CALL_SPAN):
                result = work.call()
        except Exception as exc:  # noqa: BLE001 - a failed call is counted
            print(f"call {len(lat)} failed: {type(exc).__name__}: {exc}",
                  file=sys.stderr)
            failed += 1
            end = time.perf_counter()
            break
        end = time.perf_counter()
        if keep is not None:
            keep.offer(len(lat), result)
        del result
        lat.append(end - t0)
    return len(lat) + failed, end - start, lat, failed


def run_cell(bench: dict, name: str, seed: int, seconds: float,
             trace: bool, device: str = "cuda",
             traffic: dict | None = None) -> dict:
    """Run the cell once on ``device``; the result line as a dict.
    ``traffic`` replaces keys of the cell's traffic file (the tests run
    the cells at small sizes on the CPU with it)."""
    cell = Cell(bench, name)
    cell.traffic.update(traffic or {})
    driver = importlib.import_module(
        f"portbench.drivers.{cell.traffic['driver']}")
    work = driver.setup(cell.config["codec"], cell.traffic, seed, device,
                        trace=trace)
    try:
        return _measure(cell, driver, work, seed, seconds, trace, device)
    finally:
        work.close()


def _measure(cell, driver, work, seed, seconds, trace, device) -> dict:
    for _ in range(cell.traffic["warm_calls"]):
        work.call()
    _end_phase(work)
    setup_s = time.perf_counter() - T0
    keep = _Keep(cell.traffic["keep_results"],
                 np.random.default_rng([seed, 1]))
    calls, window_s, lat, failed = _loop(work, seconds, keep)
    _end_phase(work)
    if lat:
        ms = sorted(x * 1e3 for x in lat)
        print(f"window {window_s:.3f} s, {calls} calls; call ms min "
              f"{ms[0]:.3f} median {ms[len(ms) // 2]:.3f} max {ms[-1]:.3f}; "
              f"first {[round(x * 1e3, 3) for x in lat[:3]]}",
              file=sys.stderr)
    run = Run(setup_s, calls - failed, window_s, work.bytes_per_call, lat,
              work.sizes, driver.STAGES)
    cuda = torch.device(device).type == "cuda"
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.chips}
    out = {}
    if trace and not failed:
        traced = min(seconds, cell.traffic["trace_seconds"])
        run.view = tracing.TraceView(tracing.record(
            lambda: _loop(work, traced)))
        _end_phase(work)
        windows = [(run.view.busy_s(), run.view.window_s)]
        windows += [(r["busy_s"], r["window_s"])
                    for r in _reports(work)]
        dev["busy_s"] = sum(b for b, _ in windows) / len(windows)
        dev["window_s"] = sum(w for _, w in windows) / len(windows)
        out["breakdown"] = {"device_ops": run.view.top_device_ops(),
                            "idle_gaps": run.view.idle_gaps()}
    else:
        _reports(work)
    dev["memory_peak_bytes"] = int(
        work.memory_peak() if hasattr(work, "memory_peak")
        else torch.cuda.max_memory_allocated() if cuda else 0)
    if cuda:
        dev["power_limit_w"] = _power_limit_w()
    checks = work.check(keep.kept, np.random.default_rng([seed, 2])) if (
        keep.kept) else [("calls_without_result", 1, 0)]
    names = cell.per_layer if trace else cell.end_to_end
    folder = "layer_metrics" if trace else "end_to_end"
    metrics = {}
    for m in names:
        value = _reader(folder, m)(run)
        if value is not None:
            metrics[m] = {"value": value, "unit": cell.units[m]}
    ok = not failed and all(v <= lim for _, v, lim in checks)
    return {"correct": ok, "attempted": calls, "failed": failed,
            "metrics": metrics, "device": dev, **out,
            "checks": {n: {"value": v, "limit": lim}
                       for n, v, lim in checks}}


def _end_phase(work) -> None:
    if hasattr(work, "end_phase"):
        work.end_phase()


def _reports(work) -> list[dict]:
    return work.gather_reports() if hasattr(work, "gather_reports") else []


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = json.loads(pathlib.Path("BENCHMARK.json").read_text())
    cell = Cell(bench, args.workload)
    if not torch.cuda.is_available():
        print("no CUDA card: the benchmark runs only on the card",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"the cell needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    line = run_cell(bench, args.workload, args.seed, args.seconds,
                    bool(args.trace))
    found = forbidden_loaded()
    if found:
        print(f"JAX modules loaded in the run: {found}", file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name} = {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
