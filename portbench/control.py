"""The control of each cell's check: a result that breaks one guarantee
the configuration states, put in the program's place, which the check
has to find not correct.

  compress cells  the program's lazy policy (``BlockCodec(policy=
                  "lazy")``): valid LZS, but not the greedy bytes of the
                  reference C encoder that the configuration states
  decode cells    the reference decoder with its history cut to 1024
                  bytes (the configuration states LZS's 2047), the step
                  that a smaller history buffer would take

    python3 -m portbench.control --workload <cell> --seeds <n> [<n> ...]

runs, for each seed, the cell's set-up at its own size, one call of the
program and the control, and prints the check's numbers of both: one
JSON line a seed. The benchmark's own runs never run it. The lazy
control of the four-card cell is computed on one card, block for block.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import importlib
import json
import multiprocessing
import pathlib
import sys

import numpy as np
import torch

from . import run
from .drivers import block_compress, dist_compress
from .reference import lzs

CUT_WINDOW = 1024


def lazy_container(work) -> bytes:
    """The file compressed with the lazy policy, as the byte API does."""
    from lzs_tpu_torch import BlockCodec

    return BlockCodec(work.block, span=work.span, policy="lazy",
                      device=work.codec.device).compress(work.data)


def lazy_shards(work):
    """The four-card result's arrays, each block compressed lazily."""
    from lzs_tpu_torch import BlockCodec
    from lzs_tpu_torch.blocks import concat_streams, pad_blocks

    codec = BlockCodec(work.block, span=work.span, policy="lazy",
                       device=work.codec.device)
    x, lens = pad_blocks(work.data, work.block)
    comp, clens, sbit, sout, nsync = codec.encode_batch(
        codec._to_device(x), codec._to_device(lens))
    flat, total = concat_streams(comp, clens)
    return (flat[:int(total)].cpu().numpy().tobytes(), clens.cpu().tolist(),
            sbit.cpu().numpy(), sout.cpu().numpy(), nsync.cpu().numpy())


def _cut_decode(stream: bytes, cap: int) -> bytes:
    return lzs.decode(stream, window=CUT_WINDOW, cap=cap)[0]


def _decode_all(streams: list[bytes], caps: list[int], workers: int):
    if workers <= 1:
        return [_cut_decode(s, c) for s, c in zip(streams, caps)]
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(workers, ctx) as pool:
        return list(pool.map(_cut_decode, streams, caps, chunksize=16))


def cut_window_decompress(work, workers: int = 1):
    """The container decode's result, (out, status) as the program gives
    it, decoded by the reference with a 1024-byte history."""
    f = lzs.parse_container(work.blob)
    streams = [work.blob[f["starts"][b]:f["starts"][b + 1]]
               for b in range(f["nblocks"])]
    outs = _decode_all(streams, [int(n) for n in work.lens], workers)
    out = np.zeros((len(outs), work.block), np.uint8)
    for row, o in zip(out, outs):
        row[:len(o)] = np.frombuffer(o, np.uint8)
    return torch.from_numpy(out), torch.zeros(len(outs), dtype=torch.int32)


def cut_window_raw(work, workers: int = 1):
    """The raw decode's result, (out, out_len, end markers), decoded by
    the reference with a 1024-byte history."""
    outs = _decode_all(work.streams, [work.block] * len(work.streams),
                       workers)
    out = np.zeros((len(outs), work.block), np.uint8)
    for row, o in zip(out, outs):
        row[:len(o)] = np.frombuffer(o, np.uint8)
    lens = torch.tensor([len(o) for o in outs], dtype=torch.int32)
    return torch.from_numpy(out), lens, torch.ones_like(lens)


#: the control of each single-card driver: fn(work, workers)
CONTROLS = {"block_compress": lambda work, workers: lazy_container(work),
            "block_decompress": cut_window_decompress,
            "raw_decode": cut_window_raw}


def readings(bench: dict, name: str, seed: int, device: str = "cuda",
             traffic: dict | None = None, workers: int = 1) -> dict:
    """The check's numbers for one program call and for the control."""
    cell = run.Cell(bench, name)
    cell.traffic.update(traffic or {})
    driver = cell.traffic["driver"]
    rng = np.random.default_rng([seed, 2])
    out = {"cell": name, "seed": seed}
    if driver == "dist_compress":
        # computed on one card, block for block: the arrays that the
        # four cards' check takes
        work = block_compress.Work(cell.config["codec"], cell.traffic, seed,
                                   device)
        t = cell.traffic
        out["control"] = dist_compress.shard_checks(
            [lazy_shards(work)], work.data, rng, block=work.block,
            span=work.span, world=t["world"], check_blocks=t["check_blocks"])
        work.close()
        return out
    mod = importlib.import_module(f"portbench.drivers.{driver}")
    work = mod.setup(cell.config["codec"], cell.traffic, seed, device)
    try:
        out["program"] = work.check([(0, work.call())], rng)
        out["control"] = work.check([(0, CONTROLS[driver](work, workers))],
                                    np.random.default_rng([seed, 2]))
        return out
    finally:
        work.close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--workers", type=int, default=8)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    bench = json.loads(pathlib.Path("BENCHMARK.json").read_text())
    for seed in args.seeds:
        r = readings(bench, args.workload, seed, workers=args.workers)
        for side in ("program", "control"):
            if side in r:
                r[side] = {n: v for n, v, _ in r[side]}
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
