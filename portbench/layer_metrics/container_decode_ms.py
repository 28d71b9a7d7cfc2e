"""Device busy ms a call under the program's spans lzs::parse, lzs::fill
and lzs::expand."""

from portbench.readers import busy_ms_per_call

STAGES = ("parse", "fill", "expand")


def read(run):
    return busy_ms_per_call(run, STAGES)
