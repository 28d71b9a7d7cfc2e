"""Host ms a call spends in the program's lzs_host::wait spans, inside
stages or not: the host blocked on the card's queue."""

from portbench import host_spans


def read(run):
    return host_spans.host_ms(run, ("wait",))
