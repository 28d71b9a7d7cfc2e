"""The 95th percentile of the latency of every call in the untraced
window of a traced run (host clock)."""

from portbench.readers import p95_call_ms as read  # noqa: F401
