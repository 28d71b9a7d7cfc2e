"""Host ms a call spends in the program's lzs_host::pad spans: the file
padded into blocks (and, over ranks, the batch padded to the mesh)."""

from portbench import host_spans


def read(run):
    return host_spans.host_ms(run, ("pad",))
