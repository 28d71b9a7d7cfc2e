"""Rank 0's device ms a call in kernels whose name starts with "nccl"
(the gather of the shards)."""

from portbench.readers import busy_ms_per_call


def read(run):
    return busy_ms_per_call(run, name_prefix="nccl")
