"""The least time of each stage of the session cell on one H100, from the
work its function needs (peaks and counts of ``portbench.roofline``).

The encode stages take ``roofline.stage_work``'s model over the links'
live positions, never the padded rows: a link's history bytes (match
sources) and its packet's bytes. ``history`` reads each link's history
and packet and writes its row's live bytes, then reads the row's tail
and writes the history: a select a byte, each byte moved once.

Sizes (the session cell's ``Work.sizes``): ``sessions``, ``live`` (history plus
packet bytes over the links, a call), ``kept`` (history bytes kept after
the call), ``cap`` (compressed row bytes a link).
"""

from __future__ import annotations

from . import roofline


def stage_work(stage: str, s: dict) -> tuple[float, float]:
    """(int32 operations, bytes) of one call's ``stage``."""
    if stage == "history":
        return s["live"] + s["kept"], 2 * s["live"] + 2 * s["kept"]
    # no sync stage runs: ``roofline`` reads "slots" for it alone
    return roofline.stage_work(stage, {
        "blocks": s["sessions"], "block": s["live"] / s["sessions"],
        "cap": s["cap"], "slots": 0})


def least_seconds(stage: str, sizes: dict) -> float:
    """The least time of one call's ``stage`` on the chip."""
    ops, nbytes = stage_work(stage, sizes)
    return max(ops / roofline.INT32_OPS_PER_S,
               nbytes / roofline.MEMORY_BYTES_PER_S)
