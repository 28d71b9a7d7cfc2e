"""LZS (ANSI X3.241-1994) wire-format specification constants.

The port's own copy of ``lzs_tpu.spec``: the same constants, size bounds
and ``LzsConfig``, so that the PyTorch package imports nothing of the JAX
one on its main path. A test holds every public constant equal to
``lzs_tpu.spec``'s.

The format is pinned by the reference C implementation
(cmcqueen/lzs-compression):

- token layout:        c/src/liblzs/lzs-compression.c:368-415
- length code tables:  c/src/liblzs/lzs-compression.c:91-124
- extension nibbles:   c/src/liblzs/lzs-compression.c:417-431
- end marker:          c/src/liblzs/lzs-compression.c:449-454
- window / constants:  c/src/liblzs/lzs.h:57-81, lzs-common.h:38-53

Stream grammar (MSB-first bit packing):

    stream     := token* end_marker pad
    token      := '0' byte(8)                              # literal
                | '1' offset length nibble*                # match
    offset     := '1' u7                                   # 1..127 (0 = end marker)
                | '0' u11                                  # 1..2047
    length     := '00' | '01' | '10'                       # 2, 3, 4
                | '1100' | '1101' | '1110'                 # 5, 6, 7
                | '1111' nibble-chain                      # >= 8
    nibble     := u4      # adds 0..15 bytes; 15 => another nibble follows
    end_marker := '1' '1' 0000000                          # short offset 0
    pad        := '0'* to byte boundary

Deterministic encoder policy (byte-identical to the reference's encoders):
at each position i choose the offset d in [1, min(i, WINDOW_SIZE)] that
maximizes min(runlen(i, d), min(remaining, SEARCH_MATCH_MAX)), ties broken
toward the smallest d (nearest); emit a match iff that value >= MIN_MATCH,
and emit the chosen offset's full run length (unbounded, via nibbles).
"""

from __future__ import annotations

import dataclasses

# --- Offset coding (lzs-common.h:38-44) ---
SHORT_OFFSET_BITS = 7
LONG_OFFSET_BITS = 11
SHORT_OFFSET_MAX = (1 << SHORT_OFFSET_BITS) - 1   # 127
LONG_OFFSET_MAX = (1 << LONG_OFFSET_BITS) - 1     # 2047

# --- Window (lzs.h:60) ---
WINDOW_SIZE = LONG_OFFSET_MAX                      # 2047 bytes of history

# --- Length coding (lzs-common.h:51-53) ---
MIN_MATCH = 2
MAX_SHORT_LENGTH = 8
EXTENDED_LENGTH_BITS = 4
MAX_EXTENDED_LENGTH = (1 << EXTENDED_LENGTH_BITS) - 1   # 15

# --- Encoder search policy (lzs-compression.c:62) ---
SEARCH_MATCH_MAX = 12

# Length code values/widths for lengths 2..8 (lzs-compression.c:91-124).
LENGTH_CODE_VALUE = {2: 0b00, 3: 0b01, 4: 0b10,
                     5: 0b1100, 6: 0b1101, 7: 0b1110, 8: 0b1111}
LENGTH_CODE_WIDTH = {2: 2, 3: 2, 4: 2, 5: 4, 6: 4, 7: 4, 8: 4}

# End marker: token flag '1' + short-offset flag '1' + 7 zero bits.
END_MARKER_BITS = 9
END_MARKER_VALUE = 0b110000000

# Buffer-sizing expansion bound of the reference (lzs.h:79-81).
DECOMPRESSION_EXPANSION = 16


def compressed_max(n: int) -> int:
    """Upper bound on compressed size of n input bytes, in bytes
    (lzs.h:75-77: 9 bits per input byte + end marker + padding)."""
    return (n + (n + 7) // 8) + 3


def decompressed_max(n: int) -> int:
    """Buffer-sizing bound on decompressed size of n compressed bytes
    (LZS_DECOMPRESSED_MAX, lzs.h:79-81)."""
    return DECOMPRESSION_EXPANSION * n


def literal_bits() -> int:
    return 9


def offset_bits(offset: int) -> int:
    """Bits used by the offset field (including the short/long flag)."""
    return (1 + SHORT_OFFSET_BITS if offset <= SHORT_OFFSET_MAX
            else 1 + LONG_OFFSET_BITS)


def length_bits(length: int) -> int:
    """Bits used by the length field for a total match length."""
    if length < MAX_SHORT_LENGTH:
        return LENGTH_CODE_WIDTH[length]
    # '1111' + one nibble per started 15-byte chunk of (length - 8), with a
    # trailing 0-valued nibble when (length - 8) is a positive multiple of 15.
    rest = length - MAX_SHORT_LENGTH
    return 4 + 4 * (rest // MAX_EXTENDED_LENGTH + 1)


def match_bits(offset: int, length: int) -> int:
    """Total bits for a match token: flag + offset + length."""
    return 1 + offset_bits(offset) + length_bits(length)


@dataclasses.dataclass(frozen=True)
class LzsConfig:
    """Static codec configuration (the standard LZS profile)."""
    window: int = WINDOW_SIZE
    short_offset_bits: int = SHORT_OFFSET_BITS
    long_offset_bits: int = LONG_OFFSET_BITS
    min_match: int = MIN_MATCH
    max_short_length: int = MAX_SHORT_LENGTH
    max_extended_length: int = MAX_EXTENDED_LENGTH
    search_match_max: int = SEARCH_MATCH_MAX


DEFAULT_CONFIG = LzsConfig()
