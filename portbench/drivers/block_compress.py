"""Container compress through the byte API: ``BlockCodec.compress(data)``,
bytes in and container bytes out, one file a call.

Traffic keys: ``file_bytes`` (the file, made by ``corpus.make_file``
from the seed), ``check_blocks`` (blocks of a kept result that the
reference encodes).
"""

from __future__ import annotations

from .. import checks, corpus
from ..reference import lzs
from . import sample

STAGES = ("candidates", "extend", "units", "pack", "sync")


class Work:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from lzs_tpu_torch import BlockCodec

        self.block, self.span = config["block"], config["span"]
        self.policy = config["policy"]
        self.data = corpus.make_file(traffic["file_bytes"], seed)
        self.codec = BlockCodec(self.block, span=self.span,
                                policy=self.policy, device=device)
        self.check_blocks = traffic["check_blocks"]
        self.bytes_per_call = len(self.data)
        nblocks = -(-len(self.data) // self.block)
        self.sizes = {"blocks": nblocks, "block": self.block,
                      "cap": lzs.cap_bytes(self.block),
                      "slots": lzs.sync_slots(self.block, self.span),
                      "span": self.span}

    def call(self) -> bytes:
        return self.codec.compress(self.data)

    def check(self, outputs: list, rng) -> list[tuple[str, int, int]]:
        return container_checks([o for _, o in outputs], self.data, rng,
                                block=self.block, span=self.span,
                                nblocks=self.sizes["blocks"],
                                check_blocks=self.check_blocks,
                                flags=int(self.policy == "lazy"))

    def close(self) -> None:
        """Nothing runs beside the calls."""


def container_checks(blobs: list[bytes], data: bytes, rng, *, block: int,
                     span: int, nblocks: int, check_blocks: int,
                     flags: int = 0) -> list[tuple[str, int, int]]:
    """The numbers compared for kept container results: results unlike
    the first, and the first's framing, sampled blocks and their round
    trip through the reference decoder."""
    blocks = sample(rng, nblocks, check_blocks)
    errs = checks.container_errors(blobs[0], data, blocks, block=block,
                                   span=span, flags=flags)
    return [("results_unlike_first", sum(b != blobs[0] for b in blobs), 0),
            ("framing_fields_off", errs["framing"], 0),
            ("blocks_unlike_reference", errs["blocks"], 0),
            ("blocks_not_round_trip", errs["roundtrip"], 0)]


def setup(config: dict, traffic: dict, seed: int, device, *,
          trace: bool = False) -> Work:
    return Work(config, traffic, seed, device)
