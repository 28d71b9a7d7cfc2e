"""Device-idle ms a call while one of the program's lzs_host:: spans
other than wait is open: the idle that the host's framing costs."""

from portbench.host_spans import idle_ms as read  # noqa: F401
