"""Device busy ms a call under the program's spans lzs::units, lzs::pack
and lzs::sync."""

from portbench.readers import busy_ms_per_call

STAGES = ("units", "pack", "sync")


def read(run):
    return busy_ms_per_call(run, STAGES)
