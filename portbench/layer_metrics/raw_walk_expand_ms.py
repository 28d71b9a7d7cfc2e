"""Device busy ms a call under the program's spans lzs::walk, lzs::records,
lzs::raw_fill and lzs::raw_expand."""

from portbench.readers import busy_ms_per_call

STAGES = ("walk", "records", "raw_fill", "raw_expand")


def read(run):
    return busy_ms_per_call(run, STAGES)
