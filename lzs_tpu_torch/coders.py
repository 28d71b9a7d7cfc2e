"""Generalized pluggable offset/length coders (the flexible "spec" layer).

Port of ``lzs_tpu.coders`` (host NumPy), on the port's own
``reference.BitReader`` / ``BitWriter`` and ``spec``. Capability parity
with the reference python framework's pluggable-coder design
(python/lzs.py:171-641: OffsetCoder1/1b/2, LengthCoder1..8 and the
LZCMCoder pipeline), as a table-driven codec. Any prefix-free length code
and any short/long/fixed offset split can be plugged; the standard LZS
profile (StandardOffsetCoder(7, 11) + StandardLengthCoder) is
wire-compatible with the reference C library.

The one device step is the match search of ``GeneralCodec.compress``:
``stream._best_matches_host`` on ``GeneralCodec.device`` (the CUDA card
unless the caller names another), parameterized by the coder-derived
window and length cap. One ``compress`` spans at most 32768 bytes (the
search's pool); longer input raises ValueError.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np

from . import spec
from .reference import BitReader, BitWriter

Token = Tuple


# ---------------------------------------------------------------------------
# Offset coders (python/lzs.py:171-286 capability)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StandardOffsetCoder:
    """Two-range offset code: '1'+short_bits | '0'+long_bits; 0 = end.

    The standard LZS offset coder is StandardOffsetCoder(7, 11)
    (lzs-common.h:38-44 semantics; python OffsetCoder1).
    """
    short_bits: int = 7
    long_bits: int = 11

    @property
    def max_offset(self) -> int:
        return (1 << self.long_bits) - 1

    def encode(self, off: Optional[int], w: BitWriter) -> None:
        if off is None:                      # end marker
            w.put(1, 1)
            w.put(0, self.short_bits)
            return
        if off <= (1 << self.short_bits) - 1:
            w.put(1, 1)
            w.put(off, self.short_bits)
        else:
            w.put(0, 1)
            w.put(off, self.long_bits)

    def decode(self, r: BitReader) -> Optional[int]:
        if r.take(1):
            off = r.take(self.short_bits)
            return None if off == 0 else off
        return r.take(self.long_bits)


@dataclasses.dataclass(frozen=True)
class BiasedOffsetCoder:
    """Long offsets biased past the short range, extending reach to
    short_max + long_max (python OffsetCoder1b capability)."""
    short_bits: int = 7
    long_bits: int = 11

    @property
    def max_offset(self) -> int:
        return ((1 << self.short_bits) - 1) + ((1 << self.long_bits) - 1)

    def encode(self, off: Optional[int], w: BitWriter) -> None:
        smax = (1 << self.short_bits) - 1
        if off is None:
            w.put(1, 1)
            w.put(0, self.short_bits)
            return
        if off <= smax:
            w.put(1, 1)
            w.put(off, self.short_bits)
        else:
            w.put(0, 1)
            w.put(off - smax, self.long_bits)

    def decode(self, r: BitReader) -> Optional[int]:
        smax = (1 << self.short_bits) - 1
        if r.take(1):
            off = r.take(self.short_bits)
            return None if off == 0 else off
        return r.take(self.long_bits) + smax


@dataclasses.dataclass(frozen=True)
class FixedOffsetCoder:
    """Flat n-bit offsets; 0 = end marker (python OffsetCoder2)."""
    bits: int = 12

    @property
    def max_offset(self) -> int:
        return (1 << self.bits) - 1

    def encode(self, off: Optional[int], w: BitWriter) -> None:
        w.put(0 if off is None else off, self.bits)

    def decode(self, r: BitReader) -> Optional[int]:
        off = r.take(self.bits)
        return None if off == 0 else off


# ---------------------------------------------------------------------------
# Length coders (python/lzs.py:289-641 capability)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PrefixLengthCoder:
    """Table-driven prefix-free length code with optional continuation.

    ``codes`` maps initial length -> (value, width); the maximum initial
    length may chain ``ext_bits``-wide continuation fields where the
    all-ones value means "more follows" (the LZS extension-nibble scheme,
    lzs-compression.c:417-431). ``ext_bits=0`` disables continuation
    (python LengthCoder8 capability).
    """
    codes: Tuple[Tuple[int, Tuple[int, int]], ...]
    ext_bits: int = 4

    @property
    def table(self) -> Dict[int, Tuple[int, int]]:
        return dict(self.codes)

    @property
    def min_len(self) -> int:
        return min(self.table)

    @property
    def max_initial(self) -> int:
        return max(self.table)

    @property
    def has_continuation(self) -> bool:
        return self.ext_bits > 0

    def encode(self, length: int, w: BitWriter) -> None:
        initial = min(length, self.max_initial)
        v, width = self.table[initial]
        w.put(v, width)
        if initial == self.max_initial and self.has_continuation:
            rest = length - initial
            emax = (1 << self.ext_bits) - 1
            while True:
                nib = min(rest, emax)
                w.put(nib, self.ext_bits)
                rest -= nib
                if nib != emax:
                    break

    def decode(self, r: BitReader) -> int:
        # walk the prefix tree bit by bit
        v, width = 0, 0
        inv = {code: ln for ln, code in self.codes}
        while True:
            v = (v << 1) | r.take(1)
            width += 1
            if (v, width) in inv:
                length = inv[(v, width)]
                break
            if width > 32:
                raise ValueError("invalid length code")
        if length == self.max_initial and self.has_continuation:
            emax = (1 << self.ext_bits) - 1
            while True:
                nib = r.take(self.ext_bits)
                length += nib
                if nib != emax:
                    break
        return length


def _codes(d: Dict[int, Tuple[int, int]]):
    return tuple(sorted(d.items()))


#: The standard LZS length code (python LengthCoder1; lzs-compression.c:91)
StandardLengthCoder = PrefixLengthCoder(_codes({
    2: (0b00, 2), 3: (0b01, 2), 4: (0b10, 2),
    5: (0b1100, 4), 6: (0b1101, 4), 7: (0b1110, 4), 8: (0b1111, 4)}))

#: Wire-exact reproductions of the reference python framework's eight
#: length coders (python/lzs.py:289-641), cross-validated in
#: tests/test_oracle_lzs.py against the reference module run in place.
#: All continuation fields are 4-bit nibbles (MAX_CONTINUED_LEN = 15).
REFERENCE_LENGTH_CODERS: Dict[str, PrefixLengthCoder] = {
    "lc1": StandardLengthCoder,                 # LengthCoder1 (standard LZS)
    "lc2": PrefixLengthCoder(_codes({           # lzs.py:343-391
        2: (0b0, 1), 3: (0b10, 2), 4: (0b1100, 4), 5: (0b1101, 4),
        6: (0b1110, 4), 7: (0b1111, 4)})),
    "lc3": PrefixLengthCoder(_codes({           # lzs.py:393-437
        2: (0b0, 1), 3: (0b10, 2), 4: (0b110, 3), 5: (0b1110, 4),
        6: (0b1111, 4)})),
    "lc4": PrefixLengthCoder(_codes({           # lzs.py:439-489
        2: (0b00, 2), 3: (0b01, 2), 4: (0b100, 3), 5: (0b101, 3),
        6: (0b1100, 4), 7: (0b1101, 4), 8: (0b1110, 4), 9: (0b1111, 4)})),
    "lc5": PrefixLengthCoder(_codes({           # lzs.py:491-537
        2: (0b00, 2), 3: (0b01, 2), 4: (0b10, 2), 5: (0b110, 3),
        6: (0b1110, 4), 7: (0b1111, 4)})),
    "lc6": PrefixLengthCoder(_codes({           # lzs.py:539-595
        2: (0b000, 3), 3: (0b001, 3), 4: (0b010, 3), 5: (0b011, 3),
        6: (0b100, 3), 7: (0b101, 3), 8: (0b110, 3), 9: (0b1110, 4),
        10: (0b1111, 4)})),
    "lc7": PrefixLengthCoder(_codes({           # lzs.py:597-619 (flat 4-bit)
        ln: (ln - 2, 4) for ln in range(2, 17)})),
    "lc8": PrefixLengthCoder(_codes({           # lzs.py:621-641 (no ext)
        ln: (ln - 3, 4) for ln in range(3, 17)}), ext_bits=0),
}

#: Preset variants: the reference tables plus framework-original profiles
LENGTH_CODER_PRESETS: Dict[str, PrefixLengthCoder] = {
    "standard": StandardLengthCoder,
    **REFERENCE_LENGTH_CODERS,
    # deeper initial range, 2-bit continuation
    "deep": PrefixLengthCoder(_codes({
        2: (0b0, 1), 3: (0b10, 2), 4: (0b110, 3), 5: (0b1110, 4),
        6: (0b11110, 5), 7: (0b111110, 6), 8: (0b111111, 6)}),
        ext_bits=2),
    # flat 4-bit lengths 2..17 with nibble continuation (LengthCoder7-like)
    "flat4": PrefixLengthCoder(_codes({
        ln: (ln - 2, 4) for ln in range(2, 18)}), ext_bits=4),
    # flat 4-bit, min length 3, no continuation (LengthCoder8-like)
    "flat4_noext": PrefixLengthCoder(_codes({
        ln: (ln - 3, 4) for ln in range(3, 19)}), ext_bits=0),
}

STANDARD_OFFSET_CODER = StandardOffsetCoder(7, 11)


# ---------------------------------------------------------------------------
# Generalized codec pipeline (python LZCMCoder capability, lzs.py:643-867)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GeneralCodec:
    """Parameterized (offset_coder, length_coder) codec with separate
    compress / encode / decode / decompress stages; the match search of
    ``compress`` runs on ``device``."""
    offset_coder: object = STANDARD_OFFSET_CODER
    length_coder: PrefixLengthCoder = StandardLengthCoder
    #: where the match search runs: the CUDA card unless the caller names
    #: another ("cpu" runs the kernels' plain torch versions)
    device: str = "cuda"

    @property
    def window(self) -> int:
        return self.offset_coder.max_offset

    @property
    def search_cap(self) -> int:
        if self.length_coder.has_continuation:
            return spec.SEARCH_MATCH_MAX
        return min(spec.SEARCH_MATCH_MAX, self.length_coder.max_initial)

    # -- stage 1: bytes -> tokens (accelerated match search) --
    def compress(self, data: bytes) -> List[Token]:
        from .stream import _best_matches_host

        n = len(data)
        if n == 0:
            return [("end",)]
        arr = np.frombuffer(data, np.uint8).astype(np.int32)
        score, off, full = _best_matches_host(
            arr, n, window=self.window, cap=self.search_cap,
            device=self.device)
        tokens: List[Token] = []
        min_len = max(self.length_coder.min_len, spec.MIN_MATCH)
        i = 0
        while i < n:
            s = int(score[i])
            if s >= min_len and int(off[i]) <= self.window:
                length = int(full[i])
                if not self.length_coder.has_continuation:
                    length = min(length, self.length_coder.max_initial)
                tokens.append(("match", int(off[i]), length))
                i += length
            else:
                tokens.append(("lit", int(arr[i])))
                i += 1
        tokens.append(("end",))
        return tokens

    # -- stage 2: tokens -> bitstream --
    def encode(self, tokens: Iterable[Token]) -> bytes:
        w = BitWriter()
        for tok in tokens:
            if tok[0] == "lit":
                w.put(0, 1)
                w.put(tok[1], 8)
            elif tok[0] == "match":
                _, off, length = tok
                w.put(1, 1)
                self.offset_coder.encode(off, w)
                self.length_coder.encode(length, w)
            elif tok[0] == "end":
                w.put(1, 1)
                self.offset_coder.encode(None, w)
                w.pad_to_byte()
            else:
                raise ValueError(f"unknown token {tok!r}")
        return w.getvalue()

    # -- stage 3: bitstream -> tokens --
    def decode(self, data: bytes, stop_at_end: bool = True) -> List[Token]:
        return list(self.gen_decode(data, stop_at_end))

    def gen_decode(self, data: bytes,
                   stop_at_end: bool = True) -> Iterator[Token]:
        r = BitReader(data)
        while r.remaining() >= 2:
            if r.take(1) == 0:
                if r.remaining() < 8:
                    return
                yield ("lit", r.take(8))
                continue
            off = self.offset_coder.decode(r)
            if off is None:
                yield ("end",)
                if stop_at_end:
                    return
                r.skip_to_byte()
                continue
            yield ("match", off, self.length_coder.decode(r))

    # -- stage 4: tokens -> bytes --
    def decompress(self, tokens: Iterable[Token]) -> bytes:
        out = bytearray()
        for b in self.gen_decompress(tokens):
            out += b
        return bytes(out)

    def gen_decompress(self, tokens: Iterable[Token],
                      ) -> Iterator[bytes]:
        """Bounded-memory streaming expansion over a sliding window
        (python gen_decompress over CircularBytesBuffer, lzs.py:853-867)."""
        win = bytearray()
        wmax = self.window + 16
        for tok in tokens:
            if tok[0] == "lit":
                piece = bytes([tok[1]])
            elif tok[0] == "match":
                _, off, length = tok
                piece = bytearray()
                for _ in range(length):
                    j = len(win) + len(piece) - off
                    if j < len(win):
                        piece.append(win[j] if j >= 0 else 0)
                    else:
                        piece.append(piece[j - len(win)])
                piece = bytes(piece)
            else:
                continue
            yield piece
            win += piece
            if len(win) > wmax:
                del win[:len(win) - self.window]

    # -- convenience --
    def compress_bytes(self, data: bytes) -> bytes:
        return self.encode(self.compress(data))

    def decompress_bytes(self, data: bytes,
                         stop_at_end: bool = False) -> bytes:
        return self.decompress(self.decode(data, stop_at_end=stop_at_end))


#: the wire-standard profile
STANDARD_CODEC = GeneralCodec()
