"""The harness on the card at small sizes (marked gpu; skips without a
card): each single-card cell's run is correct. Untraced: a process that
has profiled once may see no device events in a later profile."""

from __future__ import annotations

import pytest
import torch

from portbench import run
from small import BENCH, SEED, SMALL


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["container-32k.compress",
                                  "container-32k.decompress",
                                  "ipcomp-1500.raw-decode"])
def test_cell_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    line = run.run_cell(BENCH, cell, SEED, 0.5, False, device="cuda",
                        traffic=SMALL[cell])
    assert line["correct"] is True, line["checks"]
    assert set(line["metrics"]) == set(run.Cell(BENCH, cell).end_to_end)
