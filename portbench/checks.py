"""Comparisons of the program's container output with the reference.

Each function returns counts of what differs; a sound run reads 0 in
every one, and each count's limit is 0 (an exact comparison).
"""

from __future__ import annotations

import zlib

from .reference import lzs


def framing_errors(f: dict, *, data_len: int, block: int, span: int,
                   flags: int) -> int:
    """Header fields of a parsed container that differ from what the
    file and the codec settings fix, and a payload checksum that differs
    from the payload's adler32."""
    want = {"magic": lzs.MAGIC, "version": lzs.VERSION, "flags": flags,
            "span": span, "block": block,
            "nblocks": max(1, -(-data_len // block)), "orig": data_len}
    return sum(f[k] != v for k, v in want.items())


def payload_crc_error(blob: bytes, f: dict) -> int:
    return int(zlib.adler32(blob[f["payload_at"]:]) & 0xFFFFFFFF != f["crc"])


def block_errors(plain: bytes, stream: bytes, nsync: int, endbit: int,
                 sbit, sout, *, span: int, slots: int) -> tuple[int, int]:
    """(1 if the block's stream, sync count, end offset or sync records
    differ from the reference's greedy encoding, 1 if the reference does
    not decode the program's stream to the block) for one block.
    ``sbit``/``sout`` are the program's records, the live ones or the
    whole row of ``slots``."""
    ref = lzs.encode_block_sync(plain, span, slots)
    ref_stream, ref_sbit, ref_sout, ref_nsync, ref_end = ref
    k = len(sbit)
    bad = (stream != ref_stream or nsync != ref_nsync or endbit != ref_end
           or list(sbit) != ref_sbit[:k] or list(sout) != ref_sout[:k]
           or k not in (ref_nsync, slots))
    out, markers = lzs.decode(stream)
    return int(bad), int(out != plain or markers != 1)


def container_errors(blob: bytes, data: bytes, blocks: list[int], *,
                     block: int, span: int, flags: int = 0) -> dict:
    """The counts of one container blob against the file it holds:
    ``framing`` (header fields and checksum), ``blocks`` and
    ``roundtrip`` (over the sampled ``blocks``)."""
    slots = lzs.sync_slots(block, span)
    try:
        f = lzs.parse_container(blob)
    except ValueError:
        return {"framing": 1, "blocks": len(blocks),
                "roundtrip": len(blocks)}
    framing = framing_errors(f, data_len=len(data), block=block, span=span,
                             flags=flags) + payload_crc_error(blob, f)
    bad = trip = 0
    for b in blocks:
        if b >= f["nblocks"]:
            bad += 1
            trip += 1
            continue
        r0 = 2 * sum(f["nsync"][:b])
        recs = f["recs"][r0:r0 + 2 * f["nsync"][b]]
        x, y = block_errors(
            data[b * block:(b + 1) * block],
            blob[f["starts"][b]:f["starts"][b + 1]], f["nsync"][b],
            f["endbits"][b], recs[0::2], recs[1::2], span=span, slots=slots)
        bad += x
        trip += y
    return {"framing": framing, "blocks": bad, "roundtrip": trip}
