"""Container decode on the card for a consumer on the card:
``BlockCodec.decode_batch_status`` on one file's container arrays, which
are on the card before the window, the output left there.

Set-up compresses the file with the program (``BlockCodec.compress``) and
reads the container back into arrays with the reference's parser, as a
consumer of the file would; the check holds sampled blocks of that
container to the reference's greedy encoding, so the input is the
reference's. Traffic keys: ``file_bytes``, ``check_blocks``.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import checks, corpus
from ..reference import lzs
from . import sample, synchronize

STAGES = ("parse", "fill", "expand")


class Work:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from lzs_tpu_torch import BlockCodec

        self.block, self.span = config["block"], config["span"]
        self.device = torch.device(device)
        self.data = corpus.make_file(traffic["file_bytes"], seed)
        self.codec = BlockCodec(self.block, span=self.span,
                                policy=config["policy"], device=device)
        self.check_blocks = traffic["check_blocks"]
        self.blob = self.codec.compress(self.data)
        f = lzs.parse_container(self.blob)
        nb, cap = f["nblocks"], lzs.cap_bytes(self.block)
        slots = lzs.sync_slots(self.block, self.span)
        clens = np.array(f["clens"], np.int64)
        nsync = np.array(f["nsync"], np.int64)
        lens = np.minimum(len(self.data) - self.block * np.arange(nb),
                          self.block).astype(np.int32)
        comp = np.zeros((nb, cap), np.uint8)
        comp[np.arange(cap)[None, :] < clens[:, None]] = np.frombuffer(
            self.blob, np.uint8, offset=f["payload_at"])
        recs = np.array(f["recs"], np.int32).reshape(-1, 2)
        live = np.arange(slots)[None, :] < nsync[:, None]
        sbit = np.repeat(np.array(f["endbits"], np.int32)[:, None], slots, 1)
        sout = np.repeat(lens[:, None], slots, 1)
        sbit[live], sout[live] = recs[:, 0], recs[:, 1]
        self.lens = lens
        self.args = [torch.from_numpy(a).to(self.device)
                     for a in (comp, sbit, sout, lens)]
        self.bytes_per_call = len(self.data)
        self.sizes = {"blocks": nb, "block": self.block, "cap": cap,
                      "slots": slots, "lanes": int(nsync.sum()),
                      "span": self.span}

    def call(self):
        out, status = self.codec.decode_batch_status(*self.args)
        synchronize(self.device)
        return out, status

    def check(self, outputs: list, rng) -> list[tuple[str, int, int]]:
        plain = np.zeros((len(self.lens), self.block), np.uint8)
        plain.reshape(-1)[:len(self.data)] = np.frombuffer(self.data,
                                                           np.uint8)
        keep = np.arange(self.block)[None, :] < self.lens[:, None]
        wrong = status_bad = 0
        for _, (out, status) in outputs:
            got = out.cpu().numpy()
            wrong += int(((got != plain) & keep).sum()) if (
                got.shape == plain.shape) else plain.size
            status_bad += int((status.cpu().numpy() != 0).sum())
        errs = checks.container_errors(
            self.blob, self.data,
            sample(rng, len(self.lens), self.check_blocks),
            block=self.block, span=self.span)
        return [("bytes_unlike_file", wrong, 0),
                ("blocks_status_set", status_bad, 0),
                ("input_framing_fields_off", errs["framing"], 0),
                ("input_blocks_unlike_reference", errs["blocks"], 0),
                ("input_blocks_not_round_trip", errs["roundtrip"], 0)]

    def close(self) -> None:
        """Nothing runs beside the calls."""


def setup(config: dict, traffic: dict, seed: int, device, *,
          trace: bool = False) -> Work:
    return Work(config, traffic, seed, device)
