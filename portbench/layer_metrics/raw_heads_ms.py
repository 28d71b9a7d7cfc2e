"""Device busy ms a call under the program's spans lzs::heads."""

from portbench.readers import busy_ms_per_call

STAGES = ("heads",)


def read(run):
    return busy_ms_per_call(run, STAGES)
