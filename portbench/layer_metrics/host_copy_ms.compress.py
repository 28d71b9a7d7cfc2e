"""Host ms a call spends in the program's lzs_host::copy_in and
lzs_host::copy_out spans (their union): the blocks to the card, the
payload and the arrays back."""

from portbench import host_spans


def read(run):
    return host_spans.host_ms(run, ("copy_in", "copy_out"))
