"""The traffic that a seed makes: the same seed gives the same inputs,
and every seed the same sizes."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from portbench import run
from portbench.drivers import block_compress, raw_decode
from small import BENCH, ROOT, SEED, SMALL


def _work(module, cell, seed):
    c = run.Cell(BENCH, cell)
    c.traffic.update(SMALL[cell])
    return module.Work(c.config["codec"], c.traffic, seed, "cpu")


@pytest.mark.parametrize("seed", [SEED, 7, 2**40 + 3])
def test_file_follows_the_seed(seed):
    a = _work(block_compress, "container-32k.compress", seed)
    b = _work(block_compress, "container-32k.compress", seed)
    assert a.data == b.data and len(a.data) == 1 << 17
    assert a.sizes == b.sizes


def test_datagrams_follow_the_seed():
    a = _work(raw_decode, "ipcomp-1500.raw-decode", SEED)
    b = _work(raw_decode, "ipcomp-1500.raw-decode", SEED)
    c = _work(raw_decode, "ipcomp-1500.raw-decode", SEED + 1)
    assert a.payloads == b.payloads and a.streams == b.streams
    assert torch.equal(a.args[0], b.args[0])
    assert a.payloads != c.payloads
    # every seed sends the same lengths, in an order of its own
    assert sorted(a.lens.tolist()) == sorted(c.lens.tolist())
    assert a.bytes_per_call == c.bytes_per_call == 16 * 556 + 8 * 1480


def test_datagram_rows_hold_the_streams():
    a = _work(raw_decode, "ipcomp-1500.raw-decode", SEED)
    rows, clen = a.args
    assert rows.shape == (24, 2048) and rows.dtype == torch.uint8
    for row, n, s in zip(rows.numpy(), clen.tolist(), a.streams):
        assert bytes(row[:n]) == s and not row[n:].any()


def test_mix_files_are_data():
    for path in (ROOT / "portbench" / "traffic").iterdir():
        assert path.suffix == ".json"
        mix = json.loads(path.read_text())
        assert (ROOT / "portbench" / "drivers"
                / f"{mix['driver']}.py").exists()


def test_full_raw_mix_is_the_imix_share():
    mix = json.loads((ROOT / "portbench" / "traffic"
                      / "raw-decode.json").read_text())
    counts = dict((n, c) for n, c in mix["payload_mix"])
    assert sum(counts.values()) == 8192
    assert counts[556] / counts[1480] == pytest.approx(4, rel=1e-3)
    assert sum(n * c for n, c in mix["payload_mix"]) == 6_068_264


def test_keep_draws_from_its_seed():
    picks = []
    for _ in range(2):
        keep = run._Keep(3, np.random.default_rng([SEED, 1]))
        for i in range(50):
            keep.offer(i, i)
        picks.append(keep.kept)
    assert picks[0] == picks[1] and len(picks[0]) == 3
