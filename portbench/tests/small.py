"""The cells at sizes a CPU test run holds: the traffic keys each test
passes to ``run.run_cell``, and the benchmark's file."""

from __future__ import annotations

import json
import pathlib

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
SEED = 2**31 + 12345

SMALL = {
    "container-32k.compress": {"file_bytes": 1 << 17, "check_blocks": 4,
                               "warm_calls": 1},
    "container-32k.decompress": {"file_bytes": 1 << 17, "check_blocks": 4,
                                 "warm_calls": 1},
    "ipcomp-1500.raw-decode": {"corpus_bytes": 1 << 16,
                               "payload_mix": [[556, 16], [1480, 8]],
                               "check_streams": 6, "warm_calls": 1},
    "container-32k.compress-x4": {"file_bytes": 1 << 17, "check_blocks": 4,
                                  "warm_calls": 1, "world": 2},
}
