"""Observability: token dumps, stream stats, and profiling hooks.

Mirrors the reference's LZS_DEBUG compile-time token prints
(lzs-compression.c:64-65, lzs-decompression.c:65-66) as a runtime token
dump, and adds the metrics the reference lacks (SURVEY.md section 5):
per-block compressed sizes, ratios, and throughput accounting, plus a
``torch.profiler`` trace context that writes a Chrome trace. The port's
own copy of ``lzs_tpu.utils.debug``, over the port's ``reference``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import pathlib
import sys
import time
from typing import Optional, TextIO

from .. import reference


def dump_tokens(data: bytes, out: Optional[TextIO] = None,
                stop_at_end: bool = False) -> int:
    """Print a per-token trace of an LZS stream (LZS_DEBUG parity).

    Returns the number of tokens printed.
    """
    out = out or sys.stderr
    pos = 0
    count = 0
    for tok in reference.decode(data, stop_at_end=stop_at_end):
        if tok[0] == "lit":
            print(f"{pos:8d}  literal 0x{tok[1]:02X}", file=out)
            pos += 1
        elif tok[0] == "match":
            print(f"{pos:8d}  match offset={tok[1]} length={tok[2]}",
                  file=out)
            pos += tok[2]
        else:
            print(f"{pos:8d}  end marker", file=out)
        count += 1
    return count


@dataclasses.dataclass
class StreamStats:
    """Summary statistics of an LZS stream."""
    tokens: int = 0
    literals: int = 0
    matches: int = 0
    markers: int = 0
    match_bytes: int = 0
    out_bytes: int = 0
    comp_bytes: int = 0
    max_length: int = 0
    max_offset: int = 0

    @property
    def ratio(self) -> float:
        return self.comp_bytes / self.out_bytes if self.out_bytes else 0.0


def stream_stats(data: bytes) -> StreamStats:
    """Token-level statistics of a compressed stream."""
    s = StreamStats(comp_bytes=len(data))
    for tok in reference.decode(data, stop_at_end=False):
        s.tokens += 1
        if tok[0] == "lit":
            s.literals += 1
            s.out_bytes += 1
        elif tok[0] == "match":
            s.matches += 1
            s.match_bytes += tok[2]
            s.out_bytes += tok[2]
            s.max_length = max(s.max_length, tok[2])
            s.max_offset = max(s.max_offset, tok[1])
        else:
            s.markers += 1
    return s


@dataclasses.dataclass
class Meter:
    """Throughput/ratio accounting across codec calls."""
    raw_bytes: int = 0
    comp_bytes: int = 0
    encode_s: float = 0.0
    decode_s: float = 0.0

    def record_encode(self, raw: int, comp: int, seconds: float) -> None:
        self.raw_bytes += raw
        self.comp_bytes += comp
        self.encode_s += seconds

    def record_decode(self, raw: int, seconds: float) -> None:
        self.decode_s += seconds

    def report(self) -> dict:
        return {
            "raw_bytes": self.raw_bytes,
            "comp_bytes": self.comp_bytes,
            "ratio": (self.comp_bytes / self.raw_bytes
                      if self.raw_bytes else 0.0),
            "encode_GBps": (self.raw_bytes / self.encode_s / 1e9
                            if self.encode_s else 0.0),
            "decode_GBps": (self.raw_bytes / self.decode_s / 1e9
                            if self.decode_s else 0.0),
        }


@contextlib.contextmanager
def device_trace(logdir: str):
    """Capture a profile of a code region with ``torch.profiler`` (the
    host, and the card where there is one) and write it to
    ``logdir/trace.json`` as a Chrome trace (chrome://tracing, Perfetto).
    Yields the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    out = pathlib.Path(logdir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(str(out / "trace.json"))


@contextlib.contextmanager
def timed(label: str, out: Optional[TextIO] = None):
    """Wall-clock a host region (waits on nothing; callers should
    ``torch.cuda.synchronize()`` inside for device work)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        print(f"{label}: {(time.perf_counter() - t0) * 1e3:.2f} ms",
              file=out or sys.stderr)
