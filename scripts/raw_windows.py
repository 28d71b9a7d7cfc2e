#!/usr/bin/env python3
"""The raw decoder's input windows on one CUDA card, at several widths.

Builds the big raw file that ``chip_smoke.py`` phase ``cli`` decodes
(``chip_smoke.big_raw``: the C encoder's 32768-byte blocks of the frozen
8 MiB corpus, ``bench.make_corpus``, repeated past ``BIG_MIB`` MiB of
input). For each window width of ``--wins`` (bytes of new input,
``ops.bitpar._WIN``) it decodes the file through
``bitpar.decode_to_host`` (the CLI's route: multi-stream, no output
capacity) ``--reps`` times, checks the output against the repeated
corpus, and prints per width:

  windows   the input windows taken (``chip_smoke.windows_taken``)
  peak_gib  ``torch.cuda.max_memory_allocated`` over the decode, less
            what was allocated before it (the input on the card)
  ms        host-clock wall of each decode (synchronised) and MB/s of
            output at the median
  stages    ``lzs_tpu_torch.trace.RAW_STAGES`` ms of one more decode

and the card's name and power limit as nvidia-smi gives them. Run from
the root of a checkout:

    python3 scripts/raw_windows.py [--wins 8388608 16777216 33554432]

Imports nothing of jax.
"""

from __future__ import annotations

import argparse
import hashlib
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from bench import CORPUS_SHA, make_corpus  # noqa: E402
from chip_smoke import big_raw, cli_raw_chains, windows_taken  # noqa: E402
from lzs_tpu_torch import trace  # noqa: E402
from lzs_tpu_torch.ops import bitpar  # noqa: E402
from lzs_tpu_torch.utils import native  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--wins", type=int, nargs="+",
                    default=[1 << 23, 1 << 24, 1 << 25])
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip(), flush=True)
    data = make_corpus(1 << 23)
    if hashlib.sha256(data).hexdigest() != CORPUS_SHA:
        raise AssertionError("corpus drift")
    chain, reps = big_raw(cli_raw_chains(data, native.compress)[1])
    want = data * reps
    dev = torch.device("cuda", 0)
    comp = torch.from_numpy(np.frombuffer(chain, np.uint8).copy()).to(dev)
    print(f"raw file {len(chain)} bytes ({reps} x the corpus's blocks), "
          f"output {len(want)} bytes", flush=True)
    default = bitpar._WIN
    for win in args.wins:
        bitpar._WIN = win
        walls = []
        for i in range(args.reps + 1):
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            got, windows = windows_taken(lambda: bitpar.decode_to_host(
                comp, multi_stream=True))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated(dev) - before
            if got != want:
                raise AssertionError(f"window {win}: output differs")
            if i:                       # the first call warms up
                walls.append(1e3 * wall)
            del got
        with trace.stage_times() as times:
            bitpar.decode_to_host(comp, multi_stream=True)
        med = statistics.median(walls)
        print(f"win {win}: windows {windows}, peak_gib {peak / 2**30:.3f}, "
              f"ms {', '.join(f'{w:.1f}' for w in walls)}, "
              f"{len(want) / med / 1e3:.2f} MB/s of output at the median; "
              "stages ms: " + ", ".join(f"{s} {1e3 * times[s]:.1f}"
                                        for s in trace.RAW_STAGES),
              flush=True)
        torch.cuda.empty_cache()
    bitpar._WIN = default


if __name__ == "__main__":
    main()
