"""Container compress with blocks over ``world`` cards:
``DistributedCodec(block).compress(data)`` on every rank, each rank
encoding its contiguous shard and gathering the others' in rank order.

The run starts the ranks itself: this process is rank 0 and spawns ranks
1..world-1, which meet through a ``file://`` store in a fresh directory
under TMPDIR. Every rank makes the same file from the seed. Rank 0 drives
the loop: before each call it broadcasts a word on a gloo group (1: call,
0: end of a phase, 2: finish), so every rank makes the same calls. A
call's latency is rank 0's, which returns after the gather and the
assembly. With ``trace``, every rank records its last phase; each rank
sends rank 0 its device busy and traced window seconds and its peak
memory before it exits.

Traffic keys: ``world``, ``file_bytes``, ``check_blocks`` (spread evenly
over the ranks' shards).
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import shutil
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from .. import checks, corpus, tracing
from ..reference import lzs
from . import sample

STAGES = ("candidates", "extend", "units", "pack", "sync")
CALL, END_PHASE, FINISH = 1, 0, 2
_TIMEOUT = datetime.timedelta(seconds=300)


class Rank:
    """One rank's codec, file and control group."""

    def __init__(self, rank: int, world: int, init: str, config: dict,
                 traffic: dict, seed: int, device_type: str):
        from lzs_tpu_torch.parallel import dist as pdist

        os.environ["LOCAL_RANK"] = str(rank)
        pdist.initialize_distributed(init, world, rank,
                                     device_type=device_type,
                                     timeout=_TIMEOUT)
        self.ctrl = dist.new_group(backend="gloo", timeout=_TIMEOUT)
        mesh = pdist.make_block_mesh(device_type)
        self.codec = pdist.DistributedCodec(mesh, block=config["block"],
                                            span=config["span"])
        self.device_type = device_type
        self.data = corpus.make_file(traffic["file_bytes"], seed)
        self.word = torch.zeros(1, dtype=torch.int64)

    def say(self, word: int | None = None) -> int:
        """Rank 0 broadcasts ``word``; every rank returns it."""
        if word is not None:
            self.word[0] = word
        dist.broadcast(self.word, 0, group=self.ctrl)
        return int(self.word[0])

    def compress(self):
        return self.codec.compress(self.data)

    def peak(self) -> int:
        if self.device_type != "cuda":
            return 0
        return torch.cuda.max_memory_allocated()


def worker(rank: int, world: int, init: str, config: dict, traffic: dict,
           seed: int, device_type: str, phases: int, trace: bool) -> None:
    """A rank past 0: serve ``phases`` phases of calls (the last one
    traced with ``trace``), then report to rank 0."""
    r = Rank(rank, world, init, config, traffic, seed, device_type)
    busy = window = 0.0

    def serve():
        while r.say() == CALL:
            with torch.profiler.record_function(tracing.CALL_SPAN):
                r.compress()

    for phase in range(phases):
        if trace and phase == phases - 1:
            view = tracing.TraceView(tracing.record(serve))
            busy, window = view.busy_s(), view.window_s
        else:
            serve()
    if r.say() != FINISH:
        raise RuntimeError("rank 0 did not finish")
    dist.gather_object({"peak": r.peak(), "busy_s": busy,
                        "window_s": window}, None, dst=0, group=r.ctrl)
    dist.destroy_process_group()


class Work:
    """Rank 0: the entry's calls, and the ranks it started."""

    def __init__(self, config: dict, traffic: dict, seed: int, device, *,
                 trace: bool = False):
        device_type = torch.device(device).type
        self.world = traffic["world"]
        self.block, self.span = config["block"], config["span"]
        self.check_blocks = traffic["check_blocks"]
        self.tmp = tempfile.mkdtemp(prefix="portbench-dist-")
        init = f"file://{self.tmp}/store"
        ctx = multiprocessing.get_context("spawn")
        # warm-up, window, and with trace the traced window
        phases = 3 if trace else 2
        self.procs = [ctx.Process(target=worker, args=(
            r, self.world, init, config, traffic, seed, device_type,
            phases, trace)) for r in range(1, self.world)]
        for p in self.procs:
            p.start()
        self.rank = Rank(0, self.world, init, config, traffic, seed,
                         device_type)
        self.data = self.rank.data
        self.bytes_per_call = len(self.data)
        nblocks = -(-len(self.data) // self.block)
        self.sizes = {"blocks": nblocks // self.world, "block": self.block,
                      "cap": lzs.cap_bytes(self.block),
                      "slots": lzs.sync_slots(self.block, self.span),
                      "span": self.span}
        self.reports: list[dict] = []

    def call(self):
        self.rank.say(CALL)
        return self.rank.compress()

    def end_phase(self) -> None:
        self.rank.say(END_PHASE)

    def gather_reports(self) -> list[dict]:
        """Every other rank's peak memory and traced seconds; then the
        groups end on every rank at once (an NCCL rank that ends its
        group waits for the others)."""
        self.rank.say(FINISH)
        got = [None] * self.world
        dist.gather_object({}, got, dst=0, group=self.rank.ctrl)
        dist.destroy_process_group()
        self.reports = got[1:]
        return self.reports

    def memory_peak(self) -> int:
        return max([self.rank.peak()] + [r["peak"] for r in self.reports])

    def check(self, outputs: list, rng) -> list[tuple[str, int, int]]:
        return shard_checks([o for _, o in outputs], self.data, rng,
                            block=self.block, span=self.span,
                            world=self.world, check_blocks=self.check_blocks)

    def close(self) -> None:
        """Stop the ranks: end this rank's groups, join each rank, end
        any that does not leave."""
        if dist.is_initialized():
            dist.destroy_process_group()
        for p in self.procs:
            p.join(timeout=60)
        for p in self.procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        shutil.rmtree(self.tmp, ignore_errors=True)


def shard_checks(results: list, data: bytes, rng, *, block: int, span: int,
                 world: int, check_blocks: int) -> list[tuple[str, int, int]]:
    """The numbers compared for kept results (payload, block lengths,
    sync_bit, sync_out, nsync): results unlike the first, and the first's
    block count and payload length, and sampled blocks of every rank's
    shard against the reference, and their round trip."""
    first = results[0]
    unlike = sum(not _same(r, first) for r in results)
    payload, clens, sbit, sout, nsync = first
    nblocks = -(-len(data) // block)
    framing = int(len(clens) != nblocks) + int(len(payload) != sum(clens))
    per = nblocks // world
    blocks = [r * per + i for r in range(world)
              for i in sample(rng, per, check_blocks // world)]
    cum = np.concatenate([[0], np.cumsum(clens)])
    slots = lzs.sync_slots(block, span)
    bad = trip = 0
    for b in blocks:
        if b >= len(clens):
            bad, trip = bad + 1, trip + 1
            continue
        x, y = checks.block_errors(
            data[b * block:(b + 1) * block], payload[cum[b]:cum[b + 1]],
            int(nsync[b]), int(sbit[b, -1]), sbit[b], sout[b], span=span,
            slots=slots)
        bad, trip = bad + x, trip + y
    return [("results_unlike_first", unlike, 0),
            ("framing_fields_off", framing, 0),
            ("blocks_unlike_reference", bad, 0),
            ("blocks_not_round_trip", trip, 0)]


def _same(a, b) -> bool:
    return a[0] == b[0] and list(a[1]) == list(b[1]) and all(
        np.array_equal(x, y) for x, y in zip(a[2:], b[2:]))


def setup(config: dict, traffic: dict, seed: int, device, *,
          trace: bool = False) -> Work:
    return Work(config, traffic, seed, device, trace=trace)
