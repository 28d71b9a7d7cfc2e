"""Host ms a call spends in the program's lzs_host::container spans: end
offsets, live sync records, adler32, the header and the join (0 over
ranks, where the compress returns the arrays and builds no container)."""

from portbench import host_spans


def read(run):
    return host_spans.host_ms(run, ("container",))
