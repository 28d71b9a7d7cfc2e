#!/usr/bin/env python3
"""DistributedCodec across ranks against BlockCodec, checked on every rank.

Run one process per device with torchrun, from the root of a checkout:

    torchrun --standalone --nproc_per_node=4 scripts/dist_check.py
    torchrun --standalone --nproc_per_node=4 scripts/dist_check.py \\
        --device cpu --size 20000 --block 1024

Every rank compresses the bench corpus (``--size`` bytes of
``bench.make_corpus``) through ``DistributedCodec(make_block_mesh(device),
block=--block)`` (NCCL on CUDA, gloo on the CPU; each rank on
``cuda:<LOCAL_RANK>``) and through a ``BlockCodec`` of its own on its own
device, and checks that the payload, clens, sync arrays (sbit, sout,
nsync) and the round trip agree; any difference raises on that rank.
Then every rank times, in turns, DistributedCodec's compress and
decompress and its own BlockCodec's compress and decompress (host
clock, synchronised, median of ``--runs``). Rank 0 prints the card's
name and power limit (nvidia-smi) and, as the last line, one JSON
object with the world size and the walls (also written to ``--out``
when given).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from bench import make_corpus  # noqa: E402
from lzs_tpu_torch import parallel  # noqa: E402
from lzs_tpu_torch.blocks import BlockCodec, pad_blocks  # noqa: E402


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _median_ms(fn, device: torch.device, runs: int) -> float:
    walls = []
    for _ in range(runs):
        _sync(device)
        t0 = time.perf_counter()
        fn()
        _sync(device)
        walls.append(1e3 * (time.perf_counter() - t0))
    return sorted(walls)[len(walls) // 2]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--size", type=int, default=1 << 23)
    ap.add_argument("--block", type=int, default=1 << 15)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--out", type=pathlib.Path, default=None,
                    help="also write the JSON line to this file")
    args = ap.parse_args()

    parallel.initialize_distributed(device_type=args.device)
    dist = torch.distributed
    mesh = parallel.make_block_mesh(args.device)
    rank, world = dist.get_rank(), dist.get_world_size()
    device = (torch.device("cuda", torch.cuda.current_device())
              if args.device == "cuda" else torch.device("cpu"))
    if rank == 0 and args.device == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0], flush=True)
    data = make_corpus(args.size)
    x, lens = pad_blocks(data, args.block)
    dcodec = parallel.DistributedCodec(mesh, block=args.block)
    codec = BlockCodec(block=args.block, device=device)

    payload, clens, sbit, sout, nsync = dcodec.compress(data)
    back = dcodec.decompress(payload, clens, sbit, sout, lens)
    want = codec.encode_batch(torch.from_numpy(x).to(device),
                              torch.from_numpy(lens).to(device))
    if payload != codec.compress(data, container=False):
        raise AssertionError(f"rank {rank}: payload differs from BlockCodec")
    for name, got, w in zip(("clens", "sbit", "sout", "nsync"),
                            (np.asarray(clens), sbit, sout, nsync), want[1:],
                            strict=True):
        if not np.array_equal(got, w.cpu().numpy()):
            raise AssertionError(f"rank {rank}: {name} differs from "
                                 f"BlockCodec's")
    if back != data:
        raise AssertionError(f"rank {rank}: round trip differs")
    blob = codec.compress(data)
    dist.barrier()

    walls = {
        "DistributedCodec.compress": _median_ms(
            lambda: dcodec.compress(data), device, args.runs),
        "DistributedCodec.decompress": _median_ms(
            lambda: dcodec.decompress(payload, clens, sbit, sout, lens),
            device, args.runs),
        "BlockCodec.compress": _median_ms(
            lambda: codec.compress(data), device, args.runs),
        "BlockCodec.decompress": _median_ms(
            lambda: codec.decompress(blob), device, args.runs),
    }
    every = [None] * world
    dist.all_gather_object(every, walls)
    if rank == 0:
        out = {"world": world, "device": args.device, "bytes": len(data),
               "block": args.block, "blocks": int(x.shape[0]),
               "checked_on_ranks": world, "payload_bytes": len(payload),
               "wall_ms_median_by_rank": every}
        line = json.dumps(out)
        if args.out is not None:
            args.out.parent.mkdir(parents=True, exist_ok=True)
            args.out.write_text(line + "\n")
        print(line, flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
