"""Stateful PPP Stac LZS sessions on the card: ``SessionCodec.compress``
of one packet from each of ``sessions`` links a call, each against its
link's carried history, the output left on the card.

Every call sends the packet lengths of ``packet_mix`` ([length, count]
pairs over the links) in an order of its own drawn from the seed, so
every seed does the same work. Link s's plaintext is the run of
``corpus.make_file(corpus_bytes)`` from an offset drawn from the seed,
wrapping at the file's end, as long as the link's packets over
``plan_calls`` calls; the plan of those calls' packets is staged on the
card before the window and cycled, so a link's plaintext repeats that
run. Set-up runs whole cycles, one where every link's cycle fills a
history (as at the full size), and checks that every history then holds
2047 bytes.

After the window the check draws ``check_sessions`` links in each kept
call and holds each stream to the reference's greedy encoding of the
packet against the link's last 2047 plaintext bytes before that call,
its length, and its decode with that history; then it holds the card's
histories of as many links to their plaintext tails.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import corpus
from ..reference import lzs
from ..reference import sessions as ref
from . import sample, synchronize

STAGES = ("history", "candidates", "extend", "units", "pack")


class Work:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from lzs_tpu_torch import SessionCodec

        self.mtu, self.window = config["mtu"], config["window"]
        self.device = torch.device(device)
        nses, ncalls = traffic["sessions"], traffic["plan_calls"]
        rng = np.random.default_rng(seed)
        mix = np.concatenate([np.full(count, length, np.int64)
                              for length, count in traffic["packet_mix"]])
        if len(mix) != nses or mix.max() > self.mtu:
            raise ValueError(f"packet_mix: {len(mix)} packets for {nses} "
                             f"links, the longest {mix.max()} bytes")
        #: lens[c, s]: link s's packet length in call c of the plan
        self.lens = np.stack([mix[rng.permutation(nses)]
                              for _ in range(ncalls)])
        #: at[c, s]: link s's plaintext bytes before call c of a cycle
        self.at = np.concatenate([np.zeros((1, nses), np.int64),
                                  np.cumsum(self.lens, 0)])
        self.src = np.frombuffer(
            corpus.make_file(traffic["corpus_bytes"], seed), np.uint8)
        self.offsets = rng.integers(0, len(self.src), nses)
        self.plan_x, self.plan_n = self._stage()
        self.codec = SessionCodec(nses, mtu=self.mtu, device=device)
        self.calls = 0
        cycles = -(-self.window // int(self.at[-1].min()))
        for _ in range(cycles * ncalls):
            self.call()
        if int(self.codec.hlen.min()) != self.window:
            raise RuntimeError("a history holds fewer than "
                               f"{self.window} bytes after set-up")
        self.check_sessions = traffic["check_sessions"]
        self.bytes_per_call = int(self.lens[0].sum())
        self.sizes = {"sessions": nses,
                      "live": nses * self.window + self.bytes_per_call,
                      "kept": nses * self.window,
                      "cap": lzs.cap_bytes(self.mtu)}

    def _stage(self):
        """The plan's packets on the card: (uint8[C, S, mtu], int32[C, S])."""
        dev = self.device
        src = torch.from_numpy(self.src.copy()).to(dev)
        lens = torch.from_numpy(self.lens).to(dev)
        base = torch.from_numpy(self.offsets[None, :] + self.at[:-1]).to(dev)
        j = torch.arange(self.mtu, device=dev)
        x = torch.empty((*self.lens.shape, self.mtu), dtype=torch.uint8,
                        device=dev)
        for c in range(len(x)):
            idx = (base[c][:, None] + j) % len(self.src)
            x[c] = torch.where(j < lens[c][:, None], src[idx], 0)
        return x, lens.to(torch.int32)

    def plaintext(self, s: int, lo: int, hi: int) -> bytes:
        """Bytes [lo, hi) of link s's plaintext (its run, repeated)."""
        q = np.arange(lo, hi) % self.at[-1, s]
        return self.src[(self.offsets[s] + q) % len(self.src)].tobytes()

    def sent_before(self, call: int, s: int) -> int:
        """Link s's plaintext bytes before global call ``call``."""
        cycle, c = divmod(call, len(self.lens))
        return int(cycle * self.at[-1, s] + self.at[c, s])

    def call(self):
        c = self.calls % len(self.lens)
        out = self.codec.compress(self.plan_x[c], self.plan_n[c])
        synchronize(self.device)
        self.calls += 1
        return self.calls - 1, out

    def check(self, outputs: list, rng) -> list[tuple[str, int, int]]:
        nses = len(self.offsets)
        unlike = lens_off = trip = 0
        for _, (call, (comp, nbytes)) in outputs:
            picked = sample(rng, nses, self.check_sessions)
            rows = comp[picked].cpu().numpy()
            got_n = nbytes[picked].cpu().numpy()
            for row, k, s in zip(rows, got_n, picked):
                p = self.sent_before(call, s)
                n = int(self.lens[call % len(self.lens), s])
                hist = self.plaintext(s, max(0, p - self.window), p)
                packet = self.plaintext(s, p, p + n)
                want = ref.compress_with_history(hist, packet)
                got = row[:k].tobytes()
                unlike += got != want
                lens_off += int(k) != len(want)
                back, markers = ref.decode_with_history(hist, got)
                trip += back != packet or markers != 1
        picked = sample(rng, nses, self.check_sessions)
        hist = self.codec.hist[picked].cpu().numpy()
        hlen = self.codec.hlen[picked].cpu().numpy()
        stale = 0
        for row, k, s in zip(hist, hlen, picked):
            p = self.sent_before(self.calls, s)
            stale += row[:k].tobytes() != self.plaintext(
                s, max(0, p - self.window), p)
        return [("streams_unlike_reference", unlike, 0),
                ("lengths_off", lens_off, 0),
                ("round_trip_off", trip, 0),
                ("history_unlike_plaintext", stale, 0)]

    def close(self) -> None:
        """Nothing runs beside the calls."""


def setup(config: dict, traffic: dict, seed: int, device, *,
          trace: bool = False) -> Work:
    return Work(config, traffic, seed, device)
