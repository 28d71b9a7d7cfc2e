"""The IPComp sender (RFC 2395) on the card: ``ops.encode.encode_batch``
over a burst of datagram payloads that are on the card before the
window, each compressed alone (history reset), raw streams with no sync
records, the output left there.

The burst is the raw-decode cell's: slices of
``corpus.make_file(corpus_bytes)`` at offsets drawn from the seed, with
the lengths of ``payload_mix`` ([length, count] pairs: every seed has the
same lengths, in an order of its own), in rows of the configuration's
``block`` (the datagram limit), zero past each payload. The check holds
``check_streams`` sampled streams of every kept result to the
reference's greedy encoding, their lengths to the reference's, and their
round trip through the reference decoder.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import corpus
from ..reference import lzs
from . import sample, synchronize

STAGES = ("candidates", "extend", "units", "pack")


def payloads(traffic: dict, seed: int) -> list[bytes]:
    """The burst's payloads, drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    src = corpus.make_file(traffic["corpus_bytes"], seed)
    lens = np.concatenate([np.full(count, length, np.int32)
                           for length, count in traffic["payload_mix"]])
    lens = lens[rng.permutation(len(lens))]
    starts = rng.integers(0, len(src) - lens.max() + 1, len(lens))
    return [src[s:s + n] for s, n in zip(starts, lens)]


class Work:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from lzs_tpu_torch.ops.encode import encode_batch

        self.encode = encode_batch
        self.block = config["block"]
        self.device = torch.device(device)
        self.payloads = payloads(traffic, seed)
        self.lens = np.array([len(p) for p in self.payloads], np.int32)
        x = np.zeros((len(self.lens), self.block), np.uint8)
        for row, p in zip(x, self.payloads):
            row[:len(p)] = np.frombuffer(p, np.uint8)
        self.args = (torch.from_numpy(x).to(self.device),
                     torch.from_numpy(self.lens).to(self.device))
        self.check_streams = traffic["check_streams"]
        self.bytes_per_call = int(self.lens.sum())
        # no sync stage runs: ``roofline`` reads "slots" for it alone
        self.sizes = {"blocks": len(self.lens), "block": self.block,
                      "cap": lzs.cap_bytes(self.block), "slots": 0}

    def call(self):
        out = self.encode(*self.args)
        synchronize(self.device)
        return out

    def check(self, outputs: list, rng) -> list[tuple[str, int, int]]:
        first = outputs[0][1]
        unlike_first = sum(not (torch.equal(c, first[0])
                                and torch.equal(k, first[1]))
                           for _, (c, k) in outputs)
        unlike = lens_off = trip = 0
        for _, (comp, nbytes) in outputs:
            pinned = sample(rng, len(self.lens), self.check_streams)
            rows = comp[pinned].cpu().numpy()
            got_n = nbytes[pinned].cpu().numpy()
            for row, k, i in zip(rows, got_n, pinned):
                want = lzs.compress_block(self.payloads[i])
                got = row[:k].tobytes()
                unlike += got != want
                lens_off += int(k) != len(want)
                out, markers = lzs.decode(got)
                trip += out != self.payloads[i] or markers != 1
        return [("results_unlike_first", unlike_first, 0),
                ("streams_unlike_reference", unlike, 0),
                ("lengths_off", lens_off, 0),
                ("round_trip_off", trip, 0)]

    def close(self) -> None:
        """Nothing runs beside the calls."""


def setup(config: dict, traffic: dict, seed: int, device, *,
          trace: bool = False) -> Work:
    return Work(config, traffic, seed, device)
