"""Streaming / incremental codec API with carried 2 KiB window state.

Port of ``lzs_tpu.stream``: the analogue of the reference's incremental
state machines
(lzs_compress_incremental, lzs-compression.c:553-823;
lzs_decompress_incremental, lzs-decompression.c:459-743): complete codec
state lives in a plain serializable object — window bytes, bit-queue
remnant, parser registers, status flags — so any feed boundary is a
checkpoint/resume point (SURVEY.md section 5, "checkpoint/resume").

Design:
  * The stream compressor produces bytes **identical to the one-shot
    encoder over the concatenated feeds** (hence identical to the
    reference C encoders). Greedy token decisions are final once a token
    ends >= 12 bytes (SEARCH_MATCH_MAX) before the end of buffered input:
    both the capped score and the chosen run can no longer be changed by
    future bytes. Everything later is held back (the reference's
    INPUT_STARVED look-ahead gate, lzs-compression.c:641-647).
  * Match search per slice runs on ``device`` (the CUDA card unless the
    caller names another) over [carried window || buffered input],
    through the port's kernels: ``ops.sortmatch`` (backend "sort") or
    the exhaustive plane of ``ops.match`` (backend "exhaustive"), at
    batch 1 and a pool of 256 to 32768 positions. The greedy walk and
    the bit emission run on the host.
  * The stream decompressor is a host-side state machine with the full
    status protocol: INPUT_STARVED (bit-granular), OUTPUT_FULL with
    mid-copy resume (lzs-decompression.c:674-681), END_MARKER with
    discard-padding-and-continue semantics (:559-576), and the zero-fill
    rule for out-of-range references (:684-693).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from . import spec, trace
from .ops import match, sortmatch

# Status flags (values shared with native runtime and the reference's
# LzsCompressStatus_t / LzsDecompressStatus_t vocabulary, lzs.h:90-99,170-178)
INPUT_STARVED = 1
OUTPUT_FULL = 2       # the reference's ..._NO_OUTPUT_BUFFER_SPACE
FINISHED = 4
END_MARKER = 8
ERROR = 16            # malformed carried state (LZS_C/D_STATUS_ERROR,
                      # lzs.h:98,177 — invariant break, not bad input data)

_HOLD = spec.SEARCH_MATCH_MAX          # bytes held back until more input
_POOL = 1 << 15                        # max match-search span per slice


def _best_matches_host(arr: np.ndarray, n: int, *,
                       window: int = spec.WINDOW_SIZE,
                       cap: int = spec.SEARCH_MATCH_MAX,
                       backend: str = "sort",
                       device: torch.device | str = "cuda"):
    """Per-position match table (score, off, full) over arr[:n] (n <=
    32768) as numpy int32 arrays, searched on ``device``.

    The block is padded to a pool of 256 positions or the next power of
    two above, as JAX pads it. Backend "sort" runs
    ``sortmatch.best_matches``; "exhaustive" runs ``match.best_matches``
    ``match.FOLD`` offsets a fold (JAX folds min(4096, pool); the result
    does not depend on the fold's width).
    """
    if n > _POOL:
        raise ValueError(f"match search spans at most {_POOL}, not {n}")
    pool = 256
    while pool < n:
        pool *= 2
    x = np.zeros(pool, np.int32)
    x[:n] = arr[:n]
    with trace.stage("stream_match"):
        xt = torch.from_numpy(x).to(device)
        nt = torch.tensor(n, dtype=torch.int32, device=xt.device)
        if backend == "sort":
            out = sortmatch.best_matches(xt, nt, window=window, cap=cap)
        elif backend == "exhaustive":
            out = match.best_matches(xt, nt, window=window, cap=cap)
        else:
            raise ValueError(f"unknown backend {backend!r}")
        return tuple(t.cpu().numpy() for t in out)


class _BitSink:
    """Resumable MSB-first bit accumulator emitting whole bytes."""

    def __init__(self, acc: int = 0, nbits: int = 0) -> None:
        self.acc = acc
        self.nbits = nbits

    def put(self, value: int, width: int, out: bytearray) -> None:
        self.acc = ((self.acc << width) | (value & ((1 << width) - 1)))
        self.nbits += width
        while self.nbits >= 8:
            self.nbits -= 8
            out.append((self.acc >> self.nbits) & 0xFF)
        self.acc &= (1 << self.nbits) - 1

    def pad_to_byte(self, out: bytearray) -> None:
        if self.nbits:
            self.put(0, 8 - self.nbits, out)


@dataclasses.dataclass
class StreamCompressor:
    """Incremental LZS compressor (carried-window streaming encode).

    feed(data, max_out=...) buffers input and returns newly final
    compressed bytes, at most ``max_out`` of them per call (the
    reference's NO_OUTPUT_BUFFER_SPACE protocol: status gains OUTPUT_FULL
    and the remainder drains on subsequent calls — the drive loop of
    utils/lzs-compress.c:91-134 works unchanged). finish() flushes the
    holdback, appends the end marker, and pads; with a bounded output
    buffer, keep calling ``feed(finish=True, max_out=...)`` until the
    status carries FINISHED (the reference defers its end marker the same
    way, lzs-compression.c:796-820). Output over a whole session is
    byte-identical to ``reference.lzs_compress`` of the concatenated
    input.
    """

    window: bytes = b""
    pending: bytes = b""
    out_pending: bytes = b""
    ended: bool = False           # end marker already emitted
    bit_acc: int = 0
    bit_n: int = 0
    ext_off: int = 0              # mid-match extension run: offset (0 = off)
    ext_carry: int = 0            # matched bytes not yet emitted as nibbles
    status: int = INPUT_STARVED
    total_in: int = 0
    total_out: int = 0
    #: match-search backend: "sort" (fast path) or "exhaustive" (the
    #: brute-force plane, the incremental counterpart of
    #: lzs_simple_compress_incremental); identical output bytes
    backend: str = "sort"
    #: torch device of the match search, kept as a string so that
    #: state_dict() stays plain data (a JAX state has none: the card)
    device: str = "cuda"

    def _check_state(self) -> bool:
        ok = (0 <= self.bit_n < 8
              and 0 <= self.bit_acc < (1 << max(self.bit_n, 0))
              and len(self.window) <= spec.WINDOW_SIZE
              and 0 <= self.ext_off <= spec.WINDOW_SIZE
              and 0 <= self.ext_carry < spec.MAX_EXTENDED_LENGTH)
        if not ok:
            self.status = ERROR
        return ok

    def _resume_ext(self, rest: bytes, finish: bool, sink: "_BitSink",
                    out: bytearray) -> int:
        """Continue an in-progress match run across a feed boundary.

        The analogue of the reference's resumable COMPRESS_EXTENDED state
        (lzs-compression.c:417-431,749-774): a match alive at a feed/slice
        boundary keeps only (offset, unemitted-byte carry) as state; its
        continuation is a direct byte compare, no match search needed.
        Returns bytes of ``rest`` consumed by the run.
        """
        d = self.ext_off
        ra = np.frombuffer(rest, np.uint8)
        wa = np.frombuffer(self.window, np.uint8)[len(self.window) - d:]
        ref = np.concatenate([wa, ra])[:len(ra)]
        neq = np.nonzero(ra != ref)[0]
        e = int(neq[0]) if neq.size else len(ra)
        self.ext_carry += e
        self.window = (self.window + rest[:e])[-spec.WINDOW_SIZE:]
        emax = spec.MAX_EXTENDED_LENGTH
        if e == len(ra) and not finish:
            # run still alive: emit only the certain full nibbles
            while self.ext_carry >= emax:
                sink.put(emax, spec.EXTENDED_LENGTH_BITS, out)
                self.ext_carry -= emax
        else:
            # run terminated (or input ends): close the nibble chain
            c = self.ext_carry
            while True:
                nib = min(c, emax)
                sink.put(nib, spec.EXTENDED_LENGTH_BITS, out)
                c -= nib
                if nib != emax:
                    break
            self.ext_off = 0
            self.ext_carry = 0
        return e

    def feed(self, data: bytes = b"", finish: bool = False,
             max_out: Optional[int] = None) -> bytes:
        if self.status & FINISHED:
            raise ValueError("stream already finished")
        if self.ended and data:
            raise ValueError("data fed after finish")
        if not self._check_state():
            return b""
        self.total_in += len(data)
        buf = self.pending + data
        out = bytearray()
        sink = _BitSink(self.bit_acc, self.bit_n)
        emax = spec.MAX_EXTENDED_LENGTH
        done = 0
        # Process in slices bounded by the match search's 32768-position
        # search span; matches alive at a slice end carry over via the
        # extension state, so token decisions stay byte-identical to the
        # one-shot encoder over the concatenated input.
        while not self.ended:
            if self.ext_off:
                rest = buf[done:]
                if not rest and not finish:
                    break
                done += self._resume_ext(rest, finish, sink, out)
                if self.ext_off:
                    break                      # run alive: consumed all
                continue
            remaining = len(buf) - done
            if remaining - (0 if finish else _HOLD) <= 0:
                break
            ctx = len(self.window)
            sub = buf[done:done + (_POOL - ctx)]
            whole = len(sub) == remaining
            n = ctx + len(sub)
            # score finality needs SEARCH_MATCH_MAX bytes of look-ahead
            # (the reference's INPUT_STARVED gate, lzs-compression.c:641-647)
            limit = n - (0 if (finish and whole) else _HOLD)
            arr = np.frombuffer(self.window + sub, np.uint8).astype(np.int32)
            score, off, full = _best_matches_host(
                arr, n, backend=self.backend, device=self.device)
            i = ctx
            while i < limit:
                if score[i] >= spec.MIN_MATCH:
                    length = int(full[i])
                    end = i + length
                    if end >= n and not (finish and whole):
                        # run alive at the slice end (length >= _HOLD >= 8):
                        # emit the head now, carry the extension run
                        self._emit_match_head(int(off[i]), sink, out)
                        self.ext_off = int(off[i])
                        self.ext_carry = (n - i) - spec.MAX_SHORT_LENGTH
                        while self.ext_carry >= emax:
                            sink.put(emax, spec.EXTENDED_LENGTH_BITS, out)
                            self.ext_carry -= emax
                        i = n
                    else:
                        self._emit_match(int(off[i]), length, sink, out)
                        i = end
                else:
                    sink.put(0, 1, out)
                    sink.put(int(arr[i]), 8, out)
                    i += 1
            consumed = min(i, n) - ctx
            self.window = (self.window + sub[:consumed])[-spec.WINDOW_SIZE:]
            done += consumed
        self.pending = buf[done:]
        if finish and not self.ended:
            assert not self.pending and not self.ext_off
            sink.put(spec.END_MARKER_VALUE, spec.END_MARKER_BITS, out)
            sink.pad_to_byte(out)
            self.ended = True
        self.bit_acc, self.bit_n = sink.acc, sink.nbits

        ready = self.out_pending + bytes(out)
        if max_out is not None and len(ready) > max_out:
            ready, self.out_pending = ready[:max_out], ready[max_out:]
        else:
            self.out_pending = b""
        if self.ended and not self.out_pending:
            self.status = FINISHED | END_MARKER
        else:
            self.status = (OUTPUT_FULL if self.out_pending
                           else (INPUT_STARVED
                                 if len(self.pending) <= _HOLD else 0))
        self.total_out += len(ready)
        return ready

    def finish(self, max_out: Optional[int] = None) -> bytes:
        return self.feed(b"", finish=True, max_out=max_out)

    def _emit_match_head(self, off: int, sink: _BitSink, out: bytearray,
                         initial: int = spec.MAX_SHORT_LENGTH) -> None:
        sink.put(1, 1, out)
        if off <= spec.SHORT_OFFSET_MAX:
            sink.put(1, 1, out)
            sink.put(off, spec.SHORT_OFFSET_BITS, out)
        else:
            sink.put(0, 1, out)
            sink.put(off, spec.LONG_OFFSET_BITS, out)
        sink.put(spec.LENGTH_CODE_VALUE[initial],
                 spec.LENGTH_CODE_WIDTH[initial], out)

    def _emit_match(self, off: int, length: int, sink: _BitSink,
                    out: bytearray) -> None:
        initial = min(length, spec.MAX_SHORT_LENGTH)
        self._emit_match_head(off, sink, out, initial)
        if initial == spec.MAX_SHORT_LENGTH:
            rest = length - spec.MAX_SHORT_LENGTH
            while True:
                nib = min(rest, spec.MAX_EXTENDED_LENGTH)
                sink.put(nib, spec.EXTENDED_LENGTH_BITS, out)
                rest -= nib
                if nib != spec.MAX_EXTENDED_LENGTH:
                    break

    # -- checkpoint / resume --
    def state_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_state_dict(cls, d: dict) -> "StreamCompressor":
        return cls(**d)


@dataclasses.dataclass
class StreamDecompressor:
    """Incremental LZS decompressor (reference incremental semantics).

    feed(data, max_out=None) returns decoded bytes; state persists across
    calls at any byte/bit/copy boundary. ``stop_at_end`` mirrors the
    single-call decoder; the default crosses end markers like
    lzs_decompress_incremental (markers counted in ``markers``).
    """

    stop_at_end: bool = False
    window: bytes = b""
    in_pending: bytes = b""       # input bytes not yet drawn into the queue
    bit_acc: int = 0
    bit_n: int = 0
    mode: int = 0                 # 0 normal, 1 extended
    cur_off: int = 0
    copy_rem: int = 0             # resumable mid-copy remainder
    markers: int = 0
    status: int = INPUT_STARVED
    total_out: int = 0

    def _check_state(self) -> bool:
        ok = (self.mode in (0, 1)
              and 0 <= self.cur_off <= spec.WINDOW_SIZE
              and self.copy_rem >= 0
              and 0 <= self.bit_n <= 32
              and 0 <= self.bit_acc < (1 << max(self.bit_n, 0))
              and len(self.window) <= spec.WINDOW_SIZE)
        if not ok:
            self.status = ERROR
        return ok

    def feed(self, data: bytes = b"",
             max_out: Optional[int] = None) -> bytes:
        if self.status & FINISHED:
            return b""
        if not self._check_state():
            return b""
        data = self.in_pending + data
        acc, nb = self.bit_acc, self.bit_n
        pos = 0
        win = bytearray(self.window)
        out = bytearray()
        budget = max_out if max_out is not None else (1 << 62)
        self.status = 0

        def fill() -> None:
            nonlocal acc, nb, pos
            while nb <= 24 and pos < len(data):
                acc = (acc << 8) | data[pos]
                nb += 8
                pos += 1

        def peek(k: int) -> int:
            return (acc >> (nb - k)) & ((1 << k) - 1)

        def take(k: int) -> int:
            nonlocal acc, nb
            nb -= k
            v = (acc >> nb) & ((1 << k) - 1)
            acc &= (1 << nb) - 1
            return v

        def emit(b: int) -> None:
            out.append(b)
            win.append(b)

        while True:
            if self.copy_rem:
                while self.copy_rem and len(out) < budget:
                    j = len(win) - self.cur_off
                    emit(win[j] if j >= 0 else 0)
                    self.copy_rem -= 1
                if self.copy_rem:
                    self.status |= OUTPUT_FULL
                    break
            fill()
            if self.mode == 1:                      # extended-length nibble
                if nb < 4:
                    self.status |= INPUT_STARVED
                    break
                nib = take(4)
                self.copy_rem += nib
                if nib != spec.MAX_EXTENDED_LENGTH:
                    self.mode = 0
                continue
            # token head: peek everything, consume only when complete
            if nb < 9:
                self.status |= INPUT_STARVED
                break
            if peek(1) == 0:                        # literal
                if len(out) >= budget:
                    self.status |= OUTPUT_FULL
                    break
                take(1)
                emit(take(8))
                continue
            short = (peek(2) & 1) == 1
            if short:
                off = peek(9) & 0x7F
                if off == 0:                        # end marker
                    take(9)
                    self.markers += 1
                    self.status |= END_MARKER
                    drop = nb % 8                   # discard padding bits
                    if drop:
                        take(drop)
                    if self.stop_at_end:
                        self.status |= FINISHED
                        break
                    continue
                head = 9
            else:
                if nb < 13:
                    self.status |= INPUT_STARVED
                    break
                off = peek(13) & 0x7FF
                head = 13
            if nb < head + 2:
                self.status |= INPUT_STARVED
                break
            l2 = peek(head + 2) & 3
            if l2 < 3:
                length = l2 + 2
                take(head + 2)
            else:
                if nb < head + 4:
                    self.status |= INPUT_STARVED
                    break
                l4 = peek(head + 4) & 0xF
                take(head + 4)
                if l4 == 0xF:
                    length = spec.MAX_SHORT_LENGTH
                    self.mode = 1
                else:
                    length = 5 + (l4 & 3)
            self.cur_off = off
            self.copy_rem = length
        self.bit_acc, self.bit_n = acc, nb
        self.window = bytes(win[-spec.WINDOW_SIZE:])
        self.total_out += len(out)
        # unread input stays a byte buffer (a bignum bit queue would make
        # bounded-output draining quadratic)
        self.in_pending = data[pos:]
        return bytes(out)

    # -- checkpoint / resume --
    def state_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_state_dict(cls, d: dict) -> "StreamDecompressor":
        return cls(**d)


def _native_mod():
    """The C++ streaming runtime (``utils.native``), built and loaded.
    A failed build or load raises: nothing falls back."""
    from .utils import native

    native.load()
    return native


def compress_stream(data: bytes, feed_size: int = 1 << 16,
                    engine: str = "python",
                    device: torch.device | str | None = None) -> bytes:
    """Convenience: run a stream compressor over fixed-size feeds.

    ``engine="python"`` (the default) runs ``StreamCompressor`` (the
    checkpointable state), whose match search runs on ``device``: the
    CUDA card unless the caller names another. ``engine="auto"`` runs the
    native C++ streaming encoder on the host (the same bytes); it takes
    no ``device``, and if it cannot be built or loaded, this raises.
    """
    if engine == "auto":
        if device is not None:
            raise ValueError("engine \"auto\" (the native C++ encoder) "
                             "runs on the host and takes no device")
        nat = _native_mod()
        enc = nat.StreamEncoder()
        out = []
        try:
            for ofs in range(0, len(data), feed_size):
                out.append(enc.feed(data[ofs:ofs + feed_size])[0])
            out.append(enc.feed(b"", finish=True)[0])
        finally:
            enc.close()
        return b"".join(out)
    if engine != "python":
        raise ValueError(f"unknown engine {engine!r}")
    c = StreamCompressor(device="cuda" if device is None else str(device))
    buf = bytearray()
    for ofs in range(0, len(data), feed_size):
        buf += c.feed(data[ofs:ofs + feed_size])
    buf += c.finish()
    return bytes(buf)


def decompress_stream(data: bytes, feed_size: int = 1 << 16,
                      stop_at_end: bool = False,
                      engine: str = "auto") -> bytes:
    """Convenience: run a stream decompressor over fixed-size feeds.

    Decoding is host work on either engine, so this takes no device:
    ``engine="auto"`` (the default) runs the native C++ streaming decoder
    (a failed build or load raises), ``engine="python"`` the
    ``StreamDecompressor`` class. The native decoder always crosses end
    markers, so ``stop_at_end`` takes the class.
    """
    if engine not in ("auto", "python"):
        raise ValueError(f"unknown engine {engine!r}")
    if engine == "auto" and not stop_at_end:
        nat = _native_mod()
        dec = nat.StreamDecoder()
        out = []
        try:
            for ofs in range(0, max(len(data), 1), feed_size):
                piece = data[ofs:ofs + feed_size]
                cap = 1 << 16
                while True:
                    chunk, st = dec.feed(piece, out_cap=cap)
                    out.append(chunk)
                    piece = b""
                    if not st & nat.OUTPUT_FULL:
                        break
                    cap = min(cap * 2, 1 << 24)
        finally:
            dec.close()
        return b"".join(out)
    d = StreamDecompressor(stop_at_end=stop_at_end)
    buf = bytearray()
    for ofs in range(0, max(len(data), 1), feed_size):
        buf += d.feed(data[ofs:ofs + feed_size])
    return bytes(buf)
