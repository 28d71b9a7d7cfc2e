"""The least time each stage of the codec could take on one H100, from the
work its function needs.

Peaks (copied from ``chip_smoke.py``): device memory 3.35e12 bytes/s
(NVIDIA's H100 SXM data sheet, at the full 700 W), and int32 operations
outside the tensor cores at 132 SMs x 64 INT32 lanes x 1.98 GHz boost.
``OPS_PER_ELEMENT`` is ``chip_smoke.OPS_PER_ELEMENT``: the fewest int32
operations each function needs per element, counted from its definition
(see the comment there for each count).

A stage's least time is the larger of its bytes over the memory peak and
its operations over the int32 peak. Bytes count each input byte read once
and each output byte written once; both counts come from the cell's own
input sizes (blocks, positions, stream bytes, live sync lanes) and the
functions' definitions, never from the operands of the kernels that now
compute them, so a change of kernels leaves the yardstick where it is.
"""

from __future__ import annotations

MEMORY_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9

OPS_PER_ELEMENT = {
    "perk_level": 5 + 14 + 18, "ext_breaks": 41, "ext_fold": 17,
    "rank_mask": 2, "gather_big": 2,
    "rowscan_cummax": 1, "rowscan_rcummin": 1, "rowscan_cumsum": 1,
    "walk_tables": 21, "walk_entries": 3 / 128, "walk_descent": 22 / 7,
    "pack": 8, "sync": 18, "expand": 4, "parse": 50, "scan_parse": 35,
}
_O = OPS_PER_ELEMENT

#: match-search levels k = 2..12 (the search cap), one ``perk_level`` each
LEVELS = 11
#: a raw head's fields from its bit: flag, offset form, offset, length
#: code, long test, length (``scan_parse``'s 12 field operations)
HEAD_FIELD_OPS = 12
#: substeps a container lane parses per fed 32-bit word
SUBSTEPS = 4


def _walk_ops(nodes: float) -> float:
    """The token walk over ``nodes`` positions: tables, entries, descent."""
    return nodes * (_O["walk_tables"] + _O["walk_entries"]
                    + _O["walk_descent"])


def stage_work(stage: str, s: dict) -> tuple[float, float]:
    """(int32 operations, bytes) of one call's ``stage``.

    ``s`` holds the call's sizes: container cells ``blocks``, ``block``
    (positions a block), ``cap`` (compressed row bytes), ``slots``
    (sync slots a block), ``lanes`` (live sync lanes over all blocks),
    ``span``; raw cells ``streams``, ``in_bytes`` (the streams' bytes),
    ``out_bytes`` (bytes decoded).
    """
    if stage in ("candidates", "extend", "units", "pack", "sync"):
        pos = s["blocks"] * s["block"]
        table = {
            # best (score, offset) a position, by level: bytes in,
            # two int32 out
            "candidates": (LEVELS * _O["perk_level"] * pos, pos * (1 + 8)),
            # run ends and the probe tier: (score, offset) in, (score,
            # offset, run) out
            "extend": ((_O["ext_breaks"] + _O["ext_fold"] + _O["rank_mask"])
                       * pos, pos * (8 + 12)),
            # the token walk and its ownership scans: bytes and the three
            # tables in, (value, width) and a start flag out
            "units": (_walk_ops(pos) + 2 * pos, pos * (1 + 12 + 9)),
            # a unit's bits into words: (value, width) in, rows out
            "pack": (_O["pack"] * pos, pos * 8 + s["blocks"] * s["cap"]),
            # records: start flag, width, offset, bit offset in; two
            # int32 a slot out
            "sync": (_O["sync"] * pos,
                     pos * 13 + s["blocks"] * s["slots"] * 8),
        }
        return table[stage]
    if stage in ("parse", "fill", "expand"):
        substeps = s["lanes"] * (s["span"] // 32 + 2) * SUBSTEPS
        out = s["blocks"] * s["block"]
        table = {
            # a lane's records from its sync record and its tile: the
            # rows and records in, an int32 record a substep out
            "parse": (_O["parse"] * substeps,
                      s["blocks"] * s["cap"] + s["lanes"] * 8
                      + substeps * 4),
            "fill": (_O["rowscan_cummax"] * substeps, substeps * 8),
            "expand": (_O["expand"] * out, substeps * 4 + out),
        }
        return table[stage]
    if stage in ("heads", "walk", "records", "raw_fill", "raw_expand"):
        bits = s["in_bytes"] * 8
        slots = bits / 9
        out = s["out_bytes"]
        table = {
            # a head's fields at every bit and the nibble chains' scans
            # (K7, K9): bytes in, (step, ok, length, low) out
            "heads": ((HEAD_FIELD_OPS + 2) * bits, s["in_bytes"] + bits * 13),
            "walk": (_walk_ops(bits), bits * 5),
            # slot compaction (a max over 9 bits) and the output offsets
            "records": (bits + slots, bits * 9 + slots * 4),
            "raw_fill": (_O["rowscan_cummax"] * slots, slots * 8),
            "raw_expand": (_O["expand"] * out, slots * 4 + out),
        }
        return table[stage]
    raise KeyError(f"no work model for stage {stage!r}")


def least_seconds(stage: str, sizes: dict) -> float:
    """The least time of one call's ``stage`` on the chip."""
    ops, nbytes = stage_work(stage, sizes)
    return max(ops / INT32_OPS_PER_S, nbytes / MEMORY_BYTES_PER_S)
