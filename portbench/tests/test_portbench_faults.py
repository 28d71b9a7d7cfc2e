"""The check finds faults of the timed path: each cell, run by the
harness on the CPU at a small size past its look for a card, with the
program broken underneath, reads ``correct`` false; and the control of
each cell (``portbench.control``) fails the check the program passes."""

from __future__ import annotations

import pytest
import torch

from portbench import control, run
from small import BENCH, SEED, SMALL


def _run(cell: str) -> dict:
    return run.run_cell(BENCH, cell, SEED, 0.5, False, device="cpu",
                        traffic=SMALL[cell])


def _halve(t: torch.Tensor) -> torch.Tensor:
    """The batch's second half left out: zeros where it was."""
    t = t.clone()
    t[t.shape[0] // 2:] = 0
    return t


def _alter(t: torch.Tensor) -> torch.Tensor:
    """A byte altered in every row where it is produced."""
    t = t.clone()
    t[:, 3] ^= 0x10
    return t


def _encode_fault(kind):
    from lzs_tpu_torch import BlockCodec

    real = BlockCodec.encode_batch

    def encode(self, x, n):
        if kind == "unchanged":
            comp, clen, sbit, sout, nsync = real(self, x, n)
            return (torch.zeros_like(comp), clen, sbit, sout, nsync)
        if kind == "half":
            return tuple(_halve(o) for o in real(self, x, n))
        comp, *rest = real(self, x, n)
        return (_alter(comp), *rest)

    return encode


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
def test_compress_faults(monkeypatch, kind):
    from lzs_tpu_torch import BlockCodec

    monkeypatch.setattr(BlockCodec, "encode_batch", _encode_fault(kind))
    assert _run("container-32k.compress")["correct"] is False


def test_compress_returning_its_input_is_found(monkeypatch):
    from lzs_tpu_torch import BlockCodec

    monkeypatch.setattr(BlockCodec, "compress",
                        lambda self, data, container=True: data)
    assert _run("container-32k.compress")["correct"] is False


@pytest.mark.parametrize("cell,attr", [
    ("container-32k.decompress", "decode_batch_status"),
    ("ipcomp-1500.raw-decode", "decode_batch_raw")])
@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
def test_decode_faults(monkeypatch, cell, attr, kind):
    from lzs_tpu_torch import BlockCodec

    real = getattr(BlockCodec, attr)

    def decode(self, *args):
        out, *rest = real(self, *args)
        if kind == "unchanged":
            out = torch.zeros_like(out)
        elif kind == "half":
            out = _halve(out)
        else:
            out = _alter(out)
        return (out, *rest)

    monkeypatch.setattr(BlockCodec, attr, decode)
    assert _run(cell)["correct"] is False


@pytest.mark.parametrize("cell", list(SMALL))
def test_sound_runs_are_correct(cell):
    line = _run(cell)
    assert line["correct"] is True, line["checks"]


def test_exchange_left_out_is_found(monkeypatch):
    """Rank 0 takes part in every gather but keeps only its own shard."""
    from lzs_tpu_torch.parallel import dist as pdist

    real = pdist._all_gather

    def gather(t, group):
        whole = real(t, group)
        mine = torch.zeros_like(whole)
        mine[:t.shape[0]] = t
        return mine

    monkeypatch.setattr(pdist, "_all_gather", gather)
    assert _run("container-32k.compress-x4")["correct"] is False


@pytest.mark.parametrize("cell", list(SMALL))
def test_control_fails_the_check(cell):
    r = control.readings(BENCH, cell, SEED, device="cpu",
                         traffic=SMALL[cell])
    assert any(v > lim for _, v, lim in r["control"])
    assert all(v <= lim for _, v, lim in r.get("program", []))
