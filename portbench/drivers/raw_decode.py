"""Raw per-datagram decode on the card: ``BlockCodec.decode_batch_raw``
(engine "bits") over a batch of raw LZS streams that are on the card
before the window, the output left there.

The datagrams' payloads are slices of ``corpus.make_file(corpus_bytes)``
at offsets drawn from the seed, with the lengths of ``payload_mix``
([length, count] pairs: every seed has the same lengths, in an order of
its own). Set-up compresses each payload as one stream with history reset
(the program's greedy block encoder at ``block`` = the datagram limit)
and lays the streams out in rows of ``row_bytes``, zero past each stream;
the check holds ``check_streams`` sampled streams to the reference's
greedy encoding, so the input is the reference's. Every datagram of a
kept result is held to its payload, its length and one end marker.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import corpus
from ..reference import lzs
from . import sample, synchronize

STAGES = ("heads", "walk", "records", "raw_fill", "raw_expand")


class Work:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from lzs_tpu_torch import BlockCodec

        self.block = config["block"]
        self.device = torch.device(device)
        rng = np.random.default_rng(seed)
        src = corpus.make_file(traffic["corpus_bytes"], seed)
        lens = np.concatenate([np.full(count, length, np.int32)
                               for length, count in traffic["payload_mix"]])
        lens = lens[rng.permutation(len(lens))]
        starts = rng.integers(0, len(src) - lens.max() + 1, len(lens))
        self.payloads = [src[s:s + n] for s, n in zip(starts, lens)]
        x = np.zeros((len(lens), self.block), np.uint8)
        for row, p in zip(x, self.payloads):
            row[:len(p)] = np.frombuffer(p, np.uint8)
        self.codec = BlockCodec(self.block, policy=config["policy"],
                                device=device)
        comp, clen, _, _, _ = self.codec.encode_batch(
            torch.from_numpy(x).to(self.device),
            torch.from_numpy(lens).to(self.device))
        comp, clen = comp.cpu().numpy(), clen.cpu().numpy()
        width = traffic["row_bytes"]
        if clen.max() > width:
            raise ValueError(f"a stream of {clen.max()} bytes does not fit "
                             f"a row of {width}")
        cw = min(comp.shape[1], width)
        rows = np.zeros((len(lens), width), np.uint8)
        rows[:, :cw] = np.where(np.arange(cw)[None, :] < clen[:, None],
                                comp[:, :cw], 0)
        self.streams = [bytes(r[:c]) for r, c in zip(rows, clen)]
        self.lens = lens
        self.check_streams = traffic["check_streams"]
        self.args = (torch.from_numpy(rows).to(self.device),
                     torch.from_numpy(clen.astype(np.int32)).to(self.device))
        self.bytes_per_call = int(lens.sum())
        self.sizes = {"streams": len(lens), "in_bytes": int(clen.sum()),
                      "out_bytes": int(lens.sum())}

    def call(self):
        out = self.codec.decode_batch_raw(*self.args)
        synchronize(self.device)
        return out

    def check(self, outputs: list, rng) -> list[tuple[str, int, int]]:
        plain = np.zeros((len(self.lens), self.block), np.uint8)
        for row, p in zip(plain, self.payloads):
            row[:len(p)] = np.frombuffer(p, np.uint8)
        keep = np.arange(self.block)[None, :] < self.lens[:, None]
        wrong = lens_off = markers_off = 0
        for _, (out, out_len, markers) in outputs:
            got = out.cpu().numpy()
            wrong += int(((got != plain) & keep).sum()) if (
                got.shape == plain.shape) else plain.size
            lens_off += int((out_len.cpu().numpy() != self.lens).sum())
            markers_off += int((markers.cpu().numpy() != 1).sum())
        pinned = sample(rng, len(self.lens), self.check_streams)
        input_off = sum(lzs.compress_block(self.payloads[i])
                        != self.streams[i] for i in pinned)
        return [("bytes_unlike_payload", wrong, 0),
                ("lengths_off", lens_off, 0),
                ("end_markers_off", markers_off, 0),
                ("input_streams_unlike_reference", input_off, 0)]

    def close(self) -> None:
        """Nothing runs beside the calls."""


def setup(config: dict, traffic: dict, seed: int, device, *,
          trace: bool = False) -> Work:
    return Work(config, traffic, seed, device)
