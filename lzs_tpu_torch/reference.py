"""Executable specification of the LZS codec (NumPy, host-side oracle).

The port's own copy of ``lzs_tpu.reference`` (the port imports nothing
of the JAX package): a clear, vectorized re-statement of the
deterministic encoder policy and the decoder semantics pinned by the
reference implementation (see the port's ``spec`` for citations). The
port's streaming codec, its debug tools and its tests read it, and
``tests/test_torch_stream.py`` holds it equal to the JAX package's copy.

Encoder policy (byte-identical to the reference C encoders — verified against
lzs_compress, lzs_simple_compress and lzs_compress_incremental outputs):
  * at position i, consider offsets d in [1, min(i, 2047)]
  * score(d) = min(runlen(i, d), min(N - i, 12))
  * pick the smallest d maximizing score; match iff score >= 2
  * emit the full run length of the chosen offset (extension nibbles of up
    to 15, a 15-nibble is always followed by another nibble)

Decoder semantics (lzs-decompression.c:156-412):
  * back-references out of range produce zero bytes (per-byte check)
  * single-call mode stops at the first end marker
  * multi-stream mode discards pad bits at an end marker and continues
    (lzs-decompression.c:559-576 incremental behavior)
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from . import spec


class BitWriter:
    """MSB-first bit accumulator producing a byte stream."""

    def __init__(self) -> None:
        self._acc = 0
        self._nbits = 0
        self._out = bytearray()

    def put(self, value: int, width: int) -> None:
        if width == 0:
            return
        self._acc = (self._acc << width) | (value & ((1 << width) - 1))
        self._nbits += width
        while self._nbits >= 8:
            self._nbits -= 8
            self._out.append((self._acc >> self._nbits) & 0xFF)
        self._acc &= (1 << self._nbits) - 1

    def pad_to_byte(self) -> None:
        if self._nbits:
            self.put(0, 8 - self._nbits)

    @property
    def bit_length(self) -> int:
        return len(self._out) * 8 + self._nbits

    def getvalue(self) -> bytes:
        assert self._nbits == 0, "stream not byte aligned"
        return bytes(self._out)


class BitReader:
    """MSB-first bit reader over a byte stream."""

    def __init__(self, data: bytes) -> None:
        self._data = data
        self._pos = 0  # bit position

    def remaining(self) -> int:
        return len(self._data) * 8 - self._pos

    def take(self, width: int) -> int:
        if width > self.remaining():
            raise EOFError("bit stream exhausted")
        value = 0
        pos = self._pos
        for _ in range(width):
            byte = self._data[pos >> 3]
            value = (value << 1) | ((byte >> (7 - (pos & 7))) & 1)
            pos += 1
        self._pos = pos
        return value

    def skip_to_byte(self) -> None:
        self._pos = (self._pos + 7) & ~7


# ---------------------------------------------------------------------------
# Token-level stages (mirrors the reference python framework's clean staging:
# compress -> tokens -> encode -> bits; decode -> tokens -> decompress).
# Tokens: ('lit', byte) | ('match', offset, length) | ('end',)
# ---------------------------------------------------------------------------

Token = Tuple


def _best_match(x: np.ndarray, i: int, pad: np.ndarray) -> Tuple[int, int]:
    """Return (score, offset) of the best match at position i.

    score = min(runlen, cap) with cap = min(N - i, 12); offset is the
    smallest maximizer. (0, 0) when no offset scores >= 1.
    """
    n = len(x)
    cap = min(n - i, spec.SEARCH_MATCH_MAX)
    w = min(i, spec.WINDOW_SIZE)
    if w == 0 or cap < spec.MIN_MATCH:
        return 0, 0
    # rows: start positions p = i-w .. i-1 (offset d = i - p)
    seg = pad[i:i + cap]
    wins = np.lib.stride_tricks.sliding_window_view(pad, cap)[i - w:i]
    eq = wins == seg  # (w, cap) bool
    # match length per row: index of first False (or cap)
    neq = ~eq
    lens = np.where(neq.any(axis=1), neq.argmax(axis=1), cap)
    best = int(lens.max())
    if best == 0:
        return 0, 0
    # smallest offset = largest p = last row among maxima
    p = int(np.nonzero(lens == best)[0][-1]) + (i - w)
    return best, i - p


def _run_length(x: np.ndarray, i: int, d: int) -> int:
    """Full (uncapped) run length of the match at position i, offset d."""
    n = len(x)
    length = 0
    while i + length < n and x[i + length] == x[i + length - d]:
        length += 1
    return length


def compress(data: bytes) -> List[Token]:
    """Bytes -> token list, using the reference-equivalent greedy policy."""
    x = np.frombuffer(data, dtype=np.uint8).astype(np.int16)
    n = len(x)
    # sentinel pad so sliding windows at the tail never match real bytes
    pad = np.concatenate([x, np.full(spec.SEARCH_MATCH_MAX, -1, np.int16)])
    tokens: List[Token] = []
    i = 0
    while i < n:
        score, off = _best_match(x, i, pad)
        if score < spec.MIN_MATCH:
            tokens.append(("lit", int(x[i])))
            i += 1
        else:
            length = _run_length(x, i, off)
            tokens.append(("match", off, length))
            i += length
    tokens.append(("end",))
    return tokens


def encode(tokens: List[Token]) -> bytes:
    """Token list -> LZS bitstream (with end marker and padding)."""
    w = BitWriter()
    for tok in tokens:
        kind = tok[0]
        if kind == "lit":
            w.put(0, 1)
            w.put(tok[1], 8)
        elif kind == "match":
            _, off, length = tok
            w.put(1, 1)
            if off <= spec.SHORT_OFFSET_MAX:
                w.put(1, 1)
                w.put(off, spec.SHORT_OFFSET_BITS)
            else:
                w.put(0, 1)
                w.put(off, spec.LONG_OFFSET_BITS)
            initial = min(length, spec.MAX_SHORT_LENGTH)
            w.put(spec.LENGTH_CODE_VALUE[initial],
                  spec.LENGTH_CODE_WIDTH[initial])
            if initial == spec.MAX_SHORT_LENGTH:
                rest = length - spec.MAX_SHORT_LENGTH
                while True:
                    nib = min(rest, spec.MAX_EXTENDED_LENGTH)
                    w.put(nib, spec.EXTENDED_LENGTH_BITS)
                    rest -= nib
                    if nib != spec.MAX_EXTENDED_LENGTH:
                        break
        elif kind == "end":
            w.put(spec.END_MARKER_VALUE, spec.END_MARKER_BITS)
            w.pad_to_byte()
        else:
            raise ValueError(f"unknown token {tok!r}")
    return w.getvalue()


def lzs_compress(data: bytes) -> bytes:
    """Single-call compress: bytes -> LZS stream."""
    return encode(compress(data))


_LENGTH_DECODE = {  # 4-bit prefix -> (length, width)
    **{v: (2, 2) for v in range(0b0000, 0b0100)},
    **{v: (3, 2) for v in range(0b0100, 0b1000)},
    **{v: (4, 2) for v in range(0b1000, 0b1100)},
    0b1100: (5, 4), 0b1101: (6, 4), 0b1110: (7, 4), 0b1111: (8, 4),
}


def decode(data: bytes, stop_at_end: bool = True) -> List[Token]:
    """LZS bitstream -> token list.

    stop_at_end=True mirrors the single-call decoder (stops at the first end
    marker); False mirrors the incremental decoder, which skips padding and
    continues into a following concatenated stream.
    """
    r = BitReader(data)
    tokens: List[Token] = []
    while r.remaining() >= spec.END_MARKER_BITS:
        if r.take(1) == 0:
            tokens.append(("lit", r.take(8)))
            continue
        if r.take(1):
            off = r.take(spec.SHORT_OFFSET_BITS)
            if off == 0:
                tokens.append(("end",))
                if stop_at_end:
                    return tokens
                r.skip_to_byte()
                continue
        else:
            off = r.take(spec.LONG_OFFSET_BITS)
        head = min(4, r.remaining())
        # peek up to 4 bits to decode the length prefix
        save = r._pos
        prefix = r.take(head) << (4 - head)
        length, width = _LENGTH_DECODE[prefix]
        r._pos = save
        r.take(width)
        total = length
        if length == spec.MAX_SHORT_LENGTH:
            while True:
                nib = r.take(spec.EXTENDED_LENGTH_BITS)
                total += nib
                if nib != spec.MAX_EXTENDED_LENGTH:
                    break
        tokens.append(("match", off, total))
    return tokens


def decompress(tokens: List[Token]) -> bytes:
    """Token list -> bytes, with the reference's zero-fill rule for
    out-of-range back-references (per-byte check)."""
    out = bytearray()
    for tok in tokens:
        if tok[0] == "lit":
            out.append(tok[1])
        elif tok[0] == "match":
            _, off, length = tok
            for _ in range(length):
                j = len(out) - off
                out.append(out[j] if j >= 0 else 0)
    return bytes(out)


def lzs_decompress(data: bytes, stop_at_end: bool = True) -> bytes:
    """Single-call decompress: LZS stream -> bytes."""
    return decompress(decode(data, stop_at_end=stop_at_end))
