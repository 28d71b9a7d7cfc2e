"""Host ms a call spends outside every lzs:: stage span: the call's own
span less its stages (padding, copies, the gather, the container)."""

from portbench.readers import framing_ms as read  # noqa: F401
