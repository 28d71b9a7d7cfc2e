"""Plain LZS (ANSI X3.241-1994) reference: greedy encoder, decoder, the
container's sync records and its framing, in Python and NumPy.

This is the yardstick that decides ``correct``. It imports nothing of the
program under test and nothing of the JAX package, and it takes nothing
the program made except the outputs it judges.

Stream grammar (MSB-first bits)::

    token      := '0' byte(8)                          literal
                | '1' offset length nibble*            match
    offset     := '1' u7 (1..127) | '0' u11 (1..2047)
    length     := '00' '01' '10' (2, 3, 4) | '1100' '1101' '1110' (5, 6, 7)
                | '1111' nibble-chain (>= 8)
    nibble     := u4, adds 0..15 bytes; a 15 is followed by another
    end_marker := '1' '1' 0000000, then zero bits to a byte boundary

Greedy policy (the reference C encoders' bytes): at position i take the
offset d in [1, min(i, 2047)] that maximises min(runlen(i, d), min(n - i,
12)), the smallest such d; a match iff that score is 2 or more, emitted
with the chosen offset's whole run length.

Container (version 4) sync records: a parse step is a token head or every
sixth extension nibble of a match; slot c >= 1 of a block holds the last
step that starts before bit ``span * c`` (its bit offset, and its output
position, or for a nibble step ``opos | 1 << 17 | offset << 18``), slot 0
the stream start, and slots from ``nsync = ceil(end_bits / span)`` on the
end sentinel (end_bits, n), where end_bits is the end marker's bit offset.
"""

from __future__ import annotations

import struct

WINDOW = 2047
MIN_MATCH = 2
SEARCH_MAX = 12
SHORT_OFFSET_MAX = 127
MAX_SHORT_LENGTH = 8
EXT = 15
END_MARKER = (0b110000000, 9)
#: parse steps per extension-nibble group and the sync-record field widths
NIBBLES_PER_STEP = 6
REC_MASK = 0x1FFFFFFF

MAGIC = b"LZST"
VERSION = 4
HEADER = "<4sBBHIIQI"


def compressed_max(n: int) -> int:
    """Bytes that n input bytes can take at most: 9 bits a byte, the end
    marker and the padding."""
    return n + (n + 7) // 8 + 3


def cap_bytes(block: int) -> int:
    """The container's compressed row width for ``block`` input bytes."""
    return (compressed_max(block) + 11) & ~3


def sync_slots(block: int, span: int) -> int:
    """Sync-record slots of a block in the container."""
    return -(-(cap_bytes(block) * 8) // span) + 1


def greedy_tokens(data: bytes) -> list[tuple[int, int, int]]:
    """The greedy token list of one block: (position, offset, length),
    offset 0 for a literal (length 1)."""
    n = len(data)
    toks = []
    i = 0
    while i < n:
        cap = min(SEARCH_MAX, n - i)
        lo = max(0, i - WINDOW)
        best, bestj = 0, -1
        if i and cap >= MIN_MATCH:
            jmax = i - 1
            for k in range(MIN_MATCH, cap + 1):
                # the nearest start j in [lo, jmax] whose k bytes equal
                # the k bytes at i (they may overlap i) is the smallest
                # offset of a run of k or more; a longer run starts no
                # nearer
                j = data.rfind(data[i:i + k], lo, jmax + k)
                if j < 0:
                    break
                best, bestj, jmax = k, j, j
        if best < MIN_MATCH:
            toks.append((i, 0, 1))
            i += 1
            continue
        d = i - bestj
        length = best
        if best == SEARCH_MAX:
            length = _run_length(data, i, d, best)
        toks.append((i, d, length))
        i += length
    return toks


def _run_length(data: bytes, i: int, d: int, known: int) -> int:
    """The whole run of offset d at i, of which ``known`` bytes match."""
    n = len(data)
    length = known
    step = 256
    while i + length + step <= n and (
            data[i + length:i + length + step]
            == data[i + length - d:i + length - d + step]):
        length += step
    while i + length < n and data[i + length] == data[i + length - d]:
        length += 1
    return length


class _Bits:
    """MSB-first bit sink."""

    def __init__(self) -> None:
        self.acc = 0
        self.nbits = 0
        self.pos = 0
        self.out = bytearray()

    def put(self, value: int, width: int) -> None:
        self.acc = (self.acc << width) | value
        self.nbits += width
        self.pos += width
        while self.nbits >= 8:
            self.nbits -= 8
            self.out.append((self.acc >> self.nbits) & 0xFF)
        self.acc &= (1 << self.nbits) - 1

    def finish(self) -> bytes:
        if self.nbits:
            self.put(0, 8 - self.nbits)
        return bytes(self.out)


def encode_tokens(data: bytes, toks) -> tuple[bytes, list, int]:
    """(stream, parse steps [(bit offset, record)], end marker's bit
    offset) of a token list."""
    w = _Bits()
    steps = []
    for i, d, length in toks:
        steps.append((w.pos, i))
        if d == 0:
            w.put(data[i], 9)
            continue
        if d <= SHORT_OFFSET_MAX:
            w.put(0b11 << 7 | d, 9)
        else:
            w.put(0b10 << 11 | d, 13)
        first = min(length, MAX_SHORT_LENGTH)
        if first < 5:
            w.put(first - 2, 2)
        else:
            w.put(first + 7, 4)
        if first < MAX_SHORT_LENGTH:
            continue
        rest = length - MAX_SHORT_LENGTH
        t = 0
        while True:
            nib = min(rest, EXT)
            if t % NIBBLES_PER_STEP == 0:
                rec = (i + MAX_SHORT_LENGTH + EXT * t) | 1 << 17 | d << 18
                steps.append((w.pos, rec & REC_MASK))
            w.put(nib, 4)
            rest -= nib
            t += 1
            if nib != EXT:
                break
    end_bits = w.pos
    w.put(*END_MARKER)
    return w.finish(), steps, end_bits


def compress_block(data: bytes) -> bytes:
    """The greedy stream of one block."""
    return encode_tokens(data, greedy_tokens(data))[0]


def sync_records(steps, end_bits: int, n: int, span: int, nslots: int):
    """(sync_bit, sync_out, nsync) of one block, as lists of nslots."""
    nsync = -(-end_bits // span)
    sbit = [0] * nsync + [end_bits] * (nslots - nsync)
    sout = [0] * nsync + [n] * (nslots - nsync)
    nxt = [s[0] for s in steps[1:]] + [end_bits]
    for (bit, rec), nb in zip(steps, nxt):
        c = nb // span
        if bit // span < c < nsync:
            sbit[c] = bit
            sout[c] = rec
    return sbit, sout, nsync


def encode_block_sync(data: bytes, span: int, nslots: int):
    """(stream, sync_bit, sync_out, nsync, end_bits) of one block."""
    stream, steps, end_bits = encode_tokens(data, greedy_tokens(data))
    sbit, sout, nsync = sync_records(steps, end_bits, len(data), span,
                                     nslots)
    return stream, sbit, sout, nsync, end_bits


def decode(stream: bytes, *, window: int = WINDOW,
           cap: int | None = None) -> tuple[bytes, int]:
    """Decode one stream to its first end marker: (bytes, end markers
    read, 0 or 1). A copy whose source lies before the block, or more
    than ``window`` bytes back, reads zeros (the C decoder's rule for
    the first). ``cap`` stops the output at that many bytes."""
    data = stream + b"\0\0\0\0"
    nbits = len(stream) * 8
    out = bytearray()
    pos = 0
    limit = cap if cap is not None else 1 << 62

    def take(width: int) -> int:
        nonlocal pos
        b = pos >> 3
        word = int.from_bytes(data[b:b + 4], "big")
        value = (word >> (32 - (pos & 7) - width)) & ((1 << width) - 1)
        pos += width
        return value

    while pos + 9 <= nbits and len(out) < limit:
        if take(1) == 0:
            out.append(take(8))
            continue
        if take(1):
            d = take(7)
            if d == 0:
                return bytes(out[:limit]), 1
        else:
            d = take(11)
        code = take(2)
        if code < 3:
            length = code + 2
        else:
            length = take(2) + 5
            if length == MAX_SHORT_LENGTH:
                while True:
                    nib = take(4)
                    length += nib
                    if nib != EXT:
                        break
        if d > window or d > len(out):
            for _ in range(length):
                j = len(out) - d
                out.append(out[j] if 0 <= j and d <= window else 0)
        elif d >= length:
            start = len(out) - d
            out += out[start:start + length]
        else:
            piece = out[-d:]
            out += (piece * (length // d + 1))[:length]
    return bytes(out[:limit]), 0


def parse_container(blob: bytes) -> dict:
    """The fields of a version-4 container; raises ValueError where the
    framing does not hold together."""
    size = struct.calcsize(HEADER)
    if len(blob) < size:
        raise ValueError("container shorter than its header")
    magic, ver, flags, span, block, nblocks, orig, crc = struct.unpack_from(
        HEADER, blob)
    pos = size

    def u32(count: int) -> list[int]:
        nonlocal pos
        if pos + 4 * count > len(blob):
            raise ValueError("container truncated")
        vals = list(struct.unpack_from(f"<{count}I", blob, pos))
        pos += 4 * count
        return vals

    clens = u32(nblocks)
    nsync = u32(nblocks)
    endbits = u32(nblocks)
    recs = u32(2 * sum(nsync))
    starts = [pos]
    for c in clens:
        starts.append(starts[-1] + c)
    if starts[-1] != len(blob):
        raise ValueError("payload length differs from the block lengths")
    return {"magic": magic, "version": ver, "flags": flags, "span": span,
            "block": block, "nblocks": nblocks, "orig": orig, "crc": crc,
            "clens": clens, "nsync": nsync, "endbits": endbits,
            "recs": recs, "starts": starts, "payload_at": pos}
