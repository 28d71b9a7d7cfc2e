"""Device busy ms a call under the program's spans lzs::candidates and
lzs::extend."""

from portbench.readers import busy_ms_per_call

STAGES = ("candidates", "extend")


def read(run):
    return busy_ms_per_call(run, STAGES)
