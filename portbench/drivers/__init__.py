"""Drivers: the general code that makes a cell's inputs and calls the
entry under test. A traffic file names its driver by ``driver``; the
harness imports ``portbench.drivers.<driver>`` and calls its
``setup(config, traffic, seed, device)``, which returns a work object:

  ``call()``            one call of the entry, its result complete (bytes
                        on the host, or tensors on the card after a
                        synchronise)
  ``bytes_per_call``    the bytes one call compresses or decodes
  ``sizes``             the call's sizes for ``portbench.roofline``
  ``check(outputs, rng)``  after the window: the numbers compared, each
                        ``(name, value, limit)``, from the kept results
  ``close()``           stops what ``setup`` started

A driver reads every size from its configuration and traffic files.
"""

from __future__ import annotations

import numpy as np


def sample(rng: np.random.Generator, population: int, k: int) -> list[int]:
    """``k`` distinct indices below ``population`` drawn from ``rng``,
    sorted (all of them where ``k`` is not less)."""
    if k >= population:
        return list(range(population))
    return sorted(int(i) for i in rng.choice(population, k, replace=False))


def synchronize(device) -> None:
    """Wait for the card's work (nothing on the CPU)."""
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
