"""Ranks of lzs_tpu_torch.parallel on gloo CPU groups, for
tests/test_torch_dist.py.

No jax here: spawned ranks import this module, torch and the port only.
``codec_results`` runs every check's calls on one rank; ``spawn_world``
starts a world of ranks (spawned processes, a FileStore, a timeout on
the group and on every join) and returns each rank's results.
"""

from __future__ import annotations

import datetime
import multiprocessing
import queue
import traceback

import numpy as np

BLOCK = 1024
TIMEOUT_S = 240


def out_lens(data: bytes, block: int = BLOCK) -> list[int]:
    n = len(data)
    nb = max(1, -(-n // block))
    return [min(block, n - b * block) for b in range(nb)]


def codec_results(cases: dict[str, bytes]) -> dict:
    """On this rank, over the default group's mesh: the mesh size, each
    case's ``DistributedCodec(block=1024)`` compress and decompress, and
    whether ``encode_sharded`` refuses a batch that is not a multiple of
    the mesh size."""
    from lzs_tpu_torch.parallel import (DistributedCodec, encode_sharded,
                                        make_block_mesh)

    mesh = make_block_mesh("cpu")
    codec = DistributedCodec(mesh, block=BLOCK)
    out = {"ndev": codec.ndev, "cases": {}}
    for name, data in cases.items():
        payload, clens, sbit, sout, nsync = codec.compress(data)
        back = codec.decompress(payload, clens, sbit, sout, out_lens(data))
        out["cases"][name] = (payload, clens, sbit, sout, nsync, back)
    enc = encode_sharded(mesh)
    try:
        enc(np.zeros((codec.ndev + 1, BLOCK), np.uint8),
            np.zeros(codec.ndev + 1, np.int32))
        out["uneven_batch"] = "accepted"
    except ValueError as e:
        out["uneven_batch"] = str(e)
    return out


def _rank(rank: int, world: int, store: str, cases: dict, results) -> None:
    import torch
    import torch.distributed as dist

    from lzs_tpu_torch.parallel import initialize_distributed

    torch.set_num_threads(1)
    try:
        initialize_distributed(f"file://{store}", world, rank,
                               device_type="cpu",
                               timeout=datetime.timedelta(seconds=TIMEOUT_S))
        try:
            results.put((rank, codec_results(cases)))
        finally:
            dist.destroy_process_group()
    except BaseException:
        results.put((rank, traceback.format_exc()))
        raise


def spawn_world(world: int, store: str, cases: dict[str, bytes]) -> list:
    """Each rank's ``codec_results`` (rank order) from ``world`` spawned
    gloo ranks; raises if a rank fails or the world outlives
    TIMEOUT_S."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank, args=(r, world, store, cases, results))
             for r in range(world)]
    for p in procs:
        p.start()
    got = {}
    try:
        deadline = datetime.datetime.now() + datetime.timedelta(
            seconds=TIMEOUT_S)
        while len(got) < world:
            left = (deadline - datetime.datetime.now()).total_seconds()
            try:
                rank, res = results.get(timeout=max(left, 0.1))
            except queue.Empty:
                raise TimeoutError(f"world {world}: ranks {sorted(got)} "
                                   f"answered in {TIMEOUT_S} s") from None
            if isinstance(res, str):
                raise RuntimeError(f"rank {rank} of {world} failed:\n{res}")
            got[rank] = res
        for p in procs:
            p.join(timeout=TIMEOUT_S)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
    bad = [p.exitcode for p in procs if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"world {world}: rank exit codes {bad}")
    return [got[r] for r in range(world)]
