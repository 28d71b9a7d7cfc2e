"""GB (1e9 bytes) of input (compress) or output (decode) that the
window's calls completed, over the whole window (host clock)."""

from portbench.readers import rate_gbps as read  # noqa: F401
