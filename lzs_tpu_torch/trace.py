"""Named stage spans of the codec's pipelines, host spans of its framing.

Every stage of compress, decompress, the raw-stream decode (both
engines of ``ops.decode``), the streaming compressor's match search and
the session codec's history runs inside ``stage(name)``: a
``torch.profiler.record_function`` span named ``lzs::<name>``, which a
profiler trace shows on the host and, as a user annotation, over the
device work the stage launched. With no profiler running a span costs a
few microseconds.

``stage_times()`` is the breakdown of the real pipeline: while it is
entered, each stage also synchronises the current CUDA device before and
after itself and adds its host-clock seconds to the dict it yields. The
synchronisation serialises the stages, so use it for a breakdown and
time throughput without it.

``host(name)`` names the host's own work around the stages: a
``record_function`` span ``lzs_host::<name>`` (``HOST_SPANS``) over the
byte API's framing and over each read that blocks the host on the
card's queue (``wait``, also inside a stage), so a trace names every
idle gap of the card by what the host was doing. A host span never
synchronises and ``stage_times()`` collects nothing from it; its prefix
is not ``lzs::``, so the stages' attribution of device work is the same
with it or without it.
"""

from __future__ import annotations

import contextlib
import time

import torch

_times: dict[str, float] | None = None

#: stage names in pipeline order (compress, then decompress)
STAGES = ("candidates", "extend", "units", "pack", "sync",
          "parse", "fill", "expand")

#: stage names of the raw-stream decode, in pipeline order: per-bit head
#: fields, the head walk, slot records, record fill, expansion
RAW_STAGES = ("heads", "walk", "records", "raw_fill", "raw_expand")

#: stage names of the raw decoder's engine "scan": the bit-serial parse
#: (which writes the filled records), expansion
SCAN_STAGES = ("scan_parse", "scan_expand")

#: stage of the streaming compressor: one slice's match search on its
#: device, from the host copy in to the three tables back on the host
STREAM_STAGES = ("stream_match",)

#: stage of the session codec (``sessions.SessionCodec``): the rows of
#: [history | packet] assembled, and each link's history cut from its row
#: after the encode (the encode's own stages run between the two)
SESSION_STAGES = ("history",)

#: host spans of the compress byte APIs: the file padded into blocks, its
#: copy to the card, the host blocked on the card's queue, the shards'
#: all-gather, the copies back, and the container built on the host
HOST_SPANS = ("pad", "copy_in", "wait", "gather", "copy_out", "container")
_HOST_NAMES = {name: f"lzs_host::{name}" for name in HOST_SPANS}


def _sync() -> None:
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def stage(name: str):
    """Run the enclosed stage as the span ``lzs::<name>``."""
    with torch.profiler.record_function(f"lzs::{name}"):
        times = _times
        if times is None:
            yield
            return
        _sync()
        t0 = time.perf_counter()
        yield
        _sync()
        times[name] = times.get(name, 0.0) + time.perf_counter() - t0


def host(name: str) -> torch.profiler.record_function:
    """Run the enclosed host work as the span ``lzs_host::<name>``, one of
    ``HOST_SPANS``."""
    return torch.profiler.record_function(_HOST_NAMES[name])


@contextlib.contextmanager
def stage_times():
    """Yield a dict that collects each stage's synchronised seconds."""
    global _times
    prev, _times = _times, {}
    try:
        yield _times
    finally:
        _times = prev
