"""Device busy ms a call under the program's span lzs::history: the rows
of [history | packet] assembled and the histories cut from them."""

from portbench.readers import busy_ms_per_call

STAGES = ("history",)


def read(run):
    return busy_ms_per_call(run, STAGES)
