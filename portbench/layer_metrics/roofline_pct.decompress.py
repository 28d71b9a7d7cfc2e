"""The least time of the stages the cell runs (portbench.roofline) over
their device busy time, in percent."""

from portbench.readers import roofline_pct as read  # noqa: F401
