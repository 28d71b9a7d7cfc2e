"""Plain LZS with a carried history (RFC 1974's History Count 1): the
greedy encoder and the decoder of one packet against its link's history,
in Python.

Like ``lzs.py`` beside it, this is the yardstick that decides
``correct``; it imports that file and nothing else of the repository.
A packet's stream is the greedy parse of ``history + packet`` from the
history's end (the same search as ``lzs.greedy_tokens``: offsets up to
2047 bytes back, reaching into the history, and runs that stop at the
packet's end), ended by the end marker and zero bits to a byte.
"""

from __future__ import annotations

from . import lzs


def greedy_tokens_from(data: bytes, start: int) -> list[tuple[int, int, int]]:
    """The greedy token list of ``data[start:]`` with ``data[:start]`` as
    history: (position, offset, length), offset 0 for a literal."""
    n = len(data)
    toks = []
    i = start
    while i < n:
        cap = min(lzs.SEARCH_MAX, n - i)
        lo = max(0, i - lzs.WINDOW)
        best, bestj = 0, -1
        if i and cap >= lzs.MIN_MATCH:
            jmax = i - 1
            for k in range(lzs.MIN_MATCH, cap + 1):
                j = data.rfind(data[i:i + k], lo, jmax + k)
                if j < 0:
                    break
                best, bestj, jmax = k, j, j
        if best < lzs.MIN_MATCH:
            toks.append((i, 0, 1))
            i += 1
            continue
        d = i - bestj
        length = best
        if best == lzs.SEARCH_MAX:
            length = lzs._run_length(data, i, d, best)
        toks.append((i, d, length))
        i += length
    return toks


def compress_with_history(history: bytes, packet: bytes) -> bytes:
    """The greedy stream of ``packet`` against ``history`` (its last 2047
    bytes are the ones a match can reach)."""
    history = history[-lzs.WINDOW:]
    data = history + packet
    return lzs.encode_tokens(data, greedy_tokens_from(data, len(history)))[0]


def decode_with_history(history: bytes, stream: bytes) -> tuple[bytes, int]:
    """Decode one packet's stream to its first end marker with ``history``
    before it: (the packet's bytes, end markers read, 0 or 1). The history
    enters ``lzs.decode`` as literal tokens ahead of the stream's bits."""
    history = history[-lzs.WINDOW:]
    bits = lzs._Bits()
    for b in history:
        bits.put(b, 9)
    for b in stream:
        bits.put(b, 8)
    out, markers = lzs.decode(bits.finish())
    return out[len(history):], markers
