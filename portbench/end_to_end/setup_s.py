"""Seconds from the start of the process to the start of the window:
imports, the inputs, the kernel library's build or load, the warm-up."""


def read(run) -> float:
    return run.setup_s
