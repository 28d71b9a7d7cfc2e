"""The share of the traced window in which the card ran no activity, in
percent."""

from portbench.readers import idle_pct as read  # noqa: F401
