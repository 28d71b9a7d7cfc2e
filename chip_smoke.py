#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (lzs_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (each prints one line or more; any failure raises and exits
non-zero):

  1. device   require CUDA; print the card's name and power limit as
              nvidia-smi gives them;
  2. build    build the CUDA sources from csrc/ (one nvcc each, all at
              once) into one library and load it;
  3. kernels  every kernel wrapper call of one greedy compress +
              decompress of the frozen 8 MiB corpus (256 blocks x 32768
              bytes; the match search's level kernel runs 11 times, k =
              2 .. 12, and its probe tier's gather and rank once or more
              per wave; the decompress's lane parse once, in the lane-major form
              that the fill takes, and its step-major form on the same
              inputs beside it), of one
              decode_batch_raw of its raw payload and of the 2^18
              decode_block, and of four scan-engine decodes like phase
              6's, is recorded as it runs; each recorded
              call is then held against the kernel's plain torch version
              on the same inputs, bitwise, and the first and the last call
              of each set of tensor shapes is timed with CUDA events (so
              every kernel is checked at exactly the shapes its paths give
              it), beside its bound and, where one PyTorch call computes
              the same function, that call (ext_fold: torch.cummax of its
              prologue, for context); and the library row sort of
              one level's keys, which the level kernel keeps in shared
              memory, is timed beside that level. The scan parse's plain
              version is a torch loop of some 45 small launches per parse
              step: its comparison's own call is its one timed call
              (ONE_SHOT), and the 2^18 stream's scan parse (some 69,000
              steps, over 30 s of plain loop) is held against engine "bits"
              and the input instead (PLAIN_TOO_SLOW);
  4. main     BlockCodec(block=32768, device="cuda") compress + decompress
              of the corpus with every launch counter reset just before;
              the round trip must be exact, the raw payload must equal the
              C encoder's bytes block by block (native/lzs_native.cpp)
              and the C decoder must read it back, the lazy policy must
              round-trip, and one more pass prints each stage's time;
  5. raw      BlockCodec.decode_batch_raw of the port's raw per-block
              payload of the corpus (256 x cap bytes plus lengths), with
              the counters reset just before: every block must equal its
              input; then its GB/s and RAW_STAGES times, a batch of four
              short blocks that must decode exactly and read one end
              marker each, and one decode_block at out_cap = 2^18 of a
              C-encoded slice of the corpus just under 256 KiB, which
              must be exact and read its end marker;
  6. scan     decode.decode_batch(engine="scan") of the same raw payload,
              with the counters reset just before: every block must equal
              its input, and (out, out_len, markers) engine "bits"'s,
              bitwise; its GB/s (host clock, synchronised) and device ms
              beside phase 5's raw decode; then the 2^18 slice through
              decode_block(engine="scan") (exact, its end marker read),
              two C-encoded short pieces concatenated and decoded with
              multi_stream (both pieces, 2 markers), and the payload with a
              max_units that cuts every stream (each block a prefix of its
              input; phase 3 holds its parse to the plain version);
  7. stream   the streaming codec (lzs_tpu_torch.stream) on the first
              1 MiB of the corpus (the depth cut; the search's width is
              the stream's full pool of 32768): StreamCompressor(
              device="cuda") in 64 KiB feeds, once per backend ("sort",
              "exhaustive"), with the counters reset just before; each
              output must equal the C encoder's one-shot bytes, and
              StreamDecompressor and decompress_stream must give the
              input back; then, with the counters reset again (path
              stream_block), encode_bytes of the same 1 MiB (equal to
              the C encoder block by block) and one 32768-byte
              encode_block_sync / decode_block_sync round trip (exact,
              status 0); both backends' _best_matches_host on the card
              against device="cpu" at every pool of POOLS, and, as
              information, each backend's stream MB/s (wall), one
              32768-position slice's wall, its match search's device
              busy ms (torch.profiler, the stream's lzs::stream_match
              span) and the host share of the slice;
              phase 3 records the stream's kernel calls (the first of
              each shape) and holds them to the plain versions;
  8. counts   every kernel of each path launched at least once in that
              path's phase (4, 5, 6 and 7);
  9. corrupt  a flipped payload byte raises ValueError.

Then one JSON line with every kernel's name, route, source, the TPU
kernel it replaces, its launches in phases 4, 5, 6 and 7, its error, its
times (kernel, plain, library call or null), its bound and what bounds
it at its widest input on a counted path ("shape"), the same at every
shape (``at``), and last the line {"ok": true, "device": {...}}.

Imports torch, numpy and the port; nothing of jax or of the JAX package.
"""

from __future__ import annotations

import contextlib
import functools
import hashlib
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

from bench import CORPUS_SHA, make_corpus  # noqa: E402
from lzs_tpu_torch.blocks import BlockCodec, pad_blocks  # noqa: E402
from lzs_tpu_torch.ops import (  # noqa: E402
    _kernels, bitpar, decode, decode2, encode, pcand, pexpand, pext, pgather,
    ppack, psync, pwalk)
from lzs_tpu_torch import stream, trace  # noqa: E402
from lzs_tpu_torch.utils import native  # noqa: E402

BLOCK = 1 << 15
SIZE = 1 << 23
REPS = 10

#: kernels each path must launch (the counters are reset before each)
PATH_KERNELS = {
    "main": ("perk_level", "ext_breaks", "ext_fold", "rank_mask",
             "gather_big", "rowscan_cummax", "rowscan_rcummin", "pack",
             "sync", "expand", "walk_tables", "walk_entries",
             "walk_descent", "parse"),
    "raw": ("rowscan_rcummin", "rowscan_cumsum", "walk_tables",
            "walk_entries", "walk_descent", "rowscan_cummax", "expand"),
    "scan": ("scan_parse", "rowscan_cummax", "expand"),
    "stream": ("perk_level", "ext_breaks", "ext_fold", "rank_mask",
               "gather_big", "rowscan_rcummin"),
}
#: the stream phase's one-block entry points (encode_bytes and one
#: encode_block_sync / decode_block_sync round trip) run the main path's
#: encode and decode at batch 1
PATH_KERNELS["stream_block"] = PATH_KERNELS["main"]
#: a scan-engine step budget that cuts every stream of the raw payload
CUT_UNITS = 1000
#: the stream phase's depth cut (1 MiB of the corpus) and feed size
STREAM_SIZE = 1 << 20
STREAM_FEED = 1 << 16
#: the stream's match-search pools (batch 1), each run with n at the pool
#: and below it
POOLS = tuple(256 << k for k in range(8))


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def cuda_ms(fn, reps: int = REPS) -> float:
    """Mean milliseconds of fn() on the card over ``reps`` launches."""
    fn()
    return timed_call(fn, reps)[1]


def timed_call(fn, reps: int = 1):
    """fn()'s last result and the mean milliseconds of ``reps`` calls on
    the card (CUDA events, no warm-up call)."""
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        out = fn()
    t1.record()
    torch.cuda.synchronize()
    return out, t0.elapsed_time(t1) / reps


def native_codec():
    """The C encoder's bytes (one-shot) and a decoder of a chain of
    streams, from the port's native runtime (``utils.native``: built with
    make into the ignored build directory, bound with ctypes)."""
    native.load()

    def decompress(chain: bytes, out_cap: int) -> bytes:
        """Decode a chain of streams, reading on past each end marker."""
        return native.decompress(chain, out_cap=out_cap, multi_stream=True)

    return native.compress, decompress


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this smoke run needs one GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    line = smi.stdout.strip().splitlines()[0]
    print(line, flush=True)
    log("device", f"torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s), using "
        f"{torch.cuda.get_device_name(0)}")
    return line


def phase_build() -> None:
    t0 = time.perf_counter()
    _kernels.LIBRARY.get()
    log("build", f"{len(_kernels.sources())} sources -> "
        f"{_kernels.LIBRARY.path.name} in {time.perf_counter() - t0:.1f} s")


#: each kernel's wrapper (module, attribute) and its plain version
WRAPPERS = {
    "perk_level": (pcand, "perk_level", pcand.perk_level_plain),
    "ext_breaks": (pext, "ext_breaks", pext.ext_breaks_plain),
    "ext_fold": (pext, "ext_fold", pext.ext_fold_plain),
    "rank_mask": (pext, "rank_mask", pext.rank_mask_plain),
    "gather_big": (pgather, "gather_big", pgather.gather_big_plain),
    "rowscan_cummax": (pext, "cummax_rows", pext.cummax_rows_plain),
    "rowscan_rcummin": (pext, "rcummin_rows", pext.rcummin_rows_plain),
    "rowscan_cumsum": (pext, "cumsum_rows_wide",
                       lambda v, tile=0: pext.cumsum_rows_plain(v)),
    "walk_tables": (pwalk, "walk_tables", pwalk.walk_tables_plain),
    "walk_entries": (pwalk, "walk_entries", pwalk.walk_entries_plain),
    "walk_descent": (pwalk, "walk_descent", pwalk.walk_descent_plain),
    "pack": (ppack, "pack_rows", ppack.pack_rows_plain),
    "sync": (psync, "sync_records", psync.sync_records_plain),
    "expand": (pexpand, "expand_records", pexpand.expand_records_plain),
    "parse": (decode2, "_parse_flat", decode2._parse_flat_plain),
    "scan_parse": (decode, "_parse_scan", decode._parse_scan_plain),
}

#: kernels whose plain version runs once per comparison, whose own call
#: is then its timed call: the scan parse's plain loop issues some 45
#: launches a parse step, seconds at the payload's 17,000-step streams
ONE_SHOT = {"scan_parse"}

#: (path, kernel) whose recorded calls are held against engine "bits" and
#: the input instead of the plain version: the 2^18 stream's scan parse,
#: some 69,000 steps, over 30 s of plain loop on the card
PLAIN_TOO_SLOW = {("scan 2^18", "scan_parse")}

#: the PyTorch call that computes a kernel's function, where there is one
#: (timed beside the kernel as a yardstick; the port never calls it): each
#: entry takes the call's arguments and returns the call, ready to time.
#: torch.gather takes int64 indices only, so gather_big's are widened
#: before the timing (the clamp is a no-op on the path's in-range indices).
#: No one PyTorch call computes the lane parse or ext_fold.
LIBRARY = {
    "rowscan_cummax": lambda v: functools.partial(torch.cummax, v, dim=1),
    "rowscan_rcummin": lambda v: lambda: torch.cummin(
        v.flip(1), dim=1).values.flip(1),
    "rowscan_cumsum": lambda v, tile=0: functools.partial(
        torch.cumsum, v, dim=1, dtype=torch.int32),
    "gather_big": lambda tab, idx: functools.partial(
        torch.gather, tab, 1, idx.clamp(0, tab.shape[1] - 1).long()),
}

#: a PyTorch call timed beside a kernel for context (not its library
#: call, and not in the JSON line's library_ms): ext_fold's scan alone,
#: torch.cummax of the values its prologue prepares, without the
#: prologue's and epilogue's bytes
CONTEXT = {
    "ext_fold": ("torch.cummax of the prologue",
                 lambda packed, ext_h, score, cap: functools.partial(
                     torch.cummax, pext.fold_prologue(packed, ext_h, cap),
                     dim=1)),
}

#: H100 SXM peaks: device memory bytes/s (NVIDIA's data sheet), and int32
#: operations/s outside the tensor cores, from the lanes: 132 SMs x 64
#: INT32 lanes x 1.98 GHz boost clock
MEMORY_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9

#: the fewest int32 operations the function needs per element of its
#: first operand (expand: per output byte; gather_big: per query; parse:
#: per lane-substep; scan_parse: per parse step that this run's streams
#: take, counted as the records with output plus the end markers),
#: counted from its definition
#: and not from a kernel's code: a scan 1 (its operator); rank_mask 2
#: (add, the exclusive difference); gather_big 2 (the clamp); perk_level 37:
#: the keys 5 (compare, select, max, shift, or), the row sort 14 (a
#: comparison sort of N keys needs log2(N!) compares, 13.56 per key at
#: the path's N = 32768, rounded up; bound by bytes either way) and the
#: fold 18 (unpack 2 keys 5, window and segment tests 4,
#: hit 4, pack 4, max 1); ext_breaks 41 (capped
#: and head 11, break info 7, min 1, next break, steal and probe 14, pack
#: 8); ext_fold 17; walk_tables 21 (7 table levels, a composition and a
#: freeze test each); walk_entries 3 per tile of 128 exits; walk_descent
#: 22 per position over its 7 table entries; pack 8 per unit (offset,
#: word, shift, two-word OR); sync 18 per unit; expand 4 per byte (its
#: record, the source, a load, a store); parse 50 per lane-substep (the
#: 24-bit window of the two-word register 9, the can test 4, the cheaper
#: of the two decodes, a run of extension nibbles, 15, the record and the
#: state update 22); scan_parse 35 per step (the window at the bit
#: position 3, the input left 1, the head's fields 12 (flag, offset
#: form, offset, length code, long test, length), its width and the gate
#: 5, the length cut to the output left 2, the record 4, the state update
#: 8: bit position, count, mode, offset, markers, done)
OPS_PER_ELEMENT = {
    "perk_level": 5 + 14 + 18, "ext_breaks": 41, "ext_fold": 17,
    "rank_mask": 2, "gather_big": 2,
    "rowscan_cummax": 1, "rowscan_rcummin": 1, "rowscan_cumsum": 1,
    "walk_tables": 21, "walk_entries": 3 / 128, "walk_descent": 22 / 7,
    "pack": 8, "sync": 18, "expand": 4, "parse": 50, "scan_parse": 35,
}


@contextlib.contextmanager
def recorded_calls(first_of_shape: bool = False):
    """Record the arguments of every kernel wrapper call made inside,
    by kernel name (the wrappers run as usual); with ``first_of_shape``
    only each kernel's first call of each set of shapes (the stream's
    slices repeat their shapes many times)."""
    calls = {name: [] for name in WRAPPERS}
    seen = set()
    saved = []
    for name, (module, attr, _) in WRAPPERS.items():
        wrapper = getattr(module, attr)

        def record(*args, _name=name, _wrapper=wrapper, **kw):
            key = (_name, _shape_key(args, kw))
            if not (first_of_shape and key in seen):
                seen.add(key)
                calls[_name].append((args, kw))
            return _wrapper(*args, **kw)

        saved.append((module, attr, wrapper))
        setattr(module, attr, record)
    try:
        yield calls
    finally:
        for module, attr, wrapper in saved:
            setattr(module, attr, wrapper)


def _bytes_moved(name: str, args: tuple, kw: dict, outs: tuple) -> int:
    """Bytes the function must move: each input read once and each output
    written once, or less where this run's data needs less."""
    if name == "walk_entries":
        # one exit read per tile the chain enters, one entry written per tile
        (entries,) = outs
        base = 128 * torch.arange(entries.shape[1], device=entries.device)
        entered = ((entries >= base) & (entries < base + 128)).sum()
        return 4 * (entries.numel() + int(entered))
    if name == "ext_fold":
        # ext_h is read at heads only, score where not capped
        packed = args[0]
        heads = int(((packed >> 2) & 1).sum())
        capped = int(((packed >> 1) & 1).sum())
        return 4 * (3 * packed.numel() + heads - capped)
    if name == "gather_big":
        # an index read and an output written per query, and each table
        # entry that the queries touch read once
        tab, idx = args
        touched = torch.unique(
            torch.arange(tab.shape[0], device=idx.device)[:, None]
            * tab.shape[1] + idx.clamp(0, tab.shape[1] - 1).long())
        return 4 * (2 * idx.numel() + touched.numel())
    # the rest (the parse too: its padded record plane is its output)
    tensors = [a for a in (*args, *kw.values(), *outs) if torch.is_tensor(a)]
    return sum(t.numel() * t.element_size() for t in tensors)


def _compare(name: str, args: tuple, kw: dict, timed: bool) -> dict:
    """Kernel vs plain on the same inputs: bitwise equal; if asked, both
    timed, the library call where there is one, and the bound."""
    module, attr, plain = WRAPPERS[name]
    wrapper = getattr(module, attr)
    got = wrapper(*args, **kw)
    want, plain_once = timed_call(lambda: plain(*args, **kw))
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = 0
    for g, w in zip(got, want, strict=True):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{name}: kernel {g.dtype}{tuple(g.shape)} "
                                 f"vs plain {w.dtype}{tuple(w.shape)}")
        if g.numel():
            err = max(err, int((g.long() - w.long()).abs().max()))
    if err != 0:
        raise AssertionError(f"{name}: kernel differs from plain, "
                             f"max abs err {err}")
    if not timed:
        return {"max_abs_err": err}
    library = LIBRARY.get(name)
    bytes_ms = 1e3 * _bytes_moved(name, args, kw, got) / MEMORY_BYTES_PER_S
    elements = (got[0].numel() if name == "expand" else
                _scan_steps(got) if name == "scan_parse" else
                _numel(name, args))
    ops_ms = 1e3 * OPS_PER_ELEMENT[name] * elements / INT32_OPS_PER_S
    out = {"max_abs_err": err,
           "ms": cuda_ms(lambda: wrapper(*args, **kw)),
           "plain_ms": (plain_once if name in ONE_SHOT else
                        cuda_ms(lambda: plain(*args, **kw))),
           "library_ms": (cuda_ms(library(*args, **kw))
                          if library else None),
           "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
    if name in CONTEXT:
        label, call = CONTEXT[name]
        out["context"] = {"call": label,
                          "ms": cuda_ms(call(*args, **kw))}
    return out


def _scan_steps(outs: tuple) -> int:
    """The parse steps a scan parse's streams took, counted as its records
    with output plus its end markers (a zero extension nibble, the one
    other step without output, is not counted)."""
    recs, _, markers = outs
    return int((recs >= 0).sum()) + int(markers.sum())


def _scan_against_bits(args: tuple, kw: dict) -> dict:
    """A scan parse call held against engine "bits" instead of the plain
    loop (PLAIN_TOO_SLOW): its records, filled and expanded, must give
    the bits engine's (out, out_len, markers) on the same input, bitwise;
    its kernel time beside."""
    recs, out_len, markers = decode._parse_scan(*args, **kw)
    fill = decode2._filled_records(recs[:, :, None])
    out, _ = pexpand.expand_records(fill, out_len, kw["out_cap"])
    want = decode.decode_batch(*args, out_cap=kw["out_cap"],
                               multi_stream=kw["multi_stream"])
    if not all(torch.equal(g, w) for g, w in zip(
            (out, out_len, markers), want, strict=True)):
        raise AssertionError("scan_parse: the decode differs from engine "
                             "bits")
    return {"max_abs_err": 0, "held_against": "engine bits",
            "steps": _scan_steps((recs, out_len, markers)),
            "ms": cuda_ms(lambda: decode._parse_scan(*args, **kw))}


def _shape_key(args: tuple, kw: dict) -> str:
    """The shapes of a call's tensors and its other arguments."""
    def one(a):
        return "x".join(map(str, a.shape)) if torch.is_tensor(a) else repr(a)
    return ", ".join([one(a) for a in args]
                     + [f"{k}={one(v)}" for k, v in sorted(kw.items())])


def _tensor_key(args: tuple, kw: dict) -> str:
    """The shapes of a call's tensors alone."""
    return ", ".join("x".join(map(str, a.shape))
                     for a in (*args, *kw.values()) if torch.is_tensor(a))


def _numel(name: str, args: tuple) -> int:
    """A call's size: its first tensor's elements (gather_big: queries;
    parse: lane-substeps, B x L x 4 (span/32 + 2))."""
    if name == "gather_big":
        return args[1].numel()
    if name == "parse":
        return args[1].numel() * 4 * (args[3] // 32 + 2)
    return next(a.numel() for a in args if torch.is_tensor(a))


def phase_kernels(data: bytes, device: torch.device, native) -> dict:
    """Each kernel's wrapper vs its plain version, bitwise, on every input
    that the paths give it, recorded as they run: one greedy compress +
    decompress of the corpus (path main), one decode_batch_raw of its raw
    per-block payload (path raw) and the 2^18 decode_block (path raw,
    wide row). The first call of each shape is timed with CUDA events."""
    native_compress, _ = native
    codec = BlockCodec(block=BLOCK, device=device)
    calls = {}
    with recorded_calls() as calls["main"]:
        codec.decompress(codec.compress(data))
    comp, clen, _, _ = raw_payload(codec, data, device)
    with recorded_calls() as calls["raw"]:
        codec.decode_batch_raw(comp, clen)
    del comp, clen
    with recorded_calls() as calls["raw 2^18"]:
        decode.decode_bytes(native_compress(wide_piece(data)),
                            bitpar.MAX_OUT_CAP, device=device)
    comp, clen, _, _ = raw_payload(codec, data, device)
    with recorded_calls() as calls["scan"]:
        decode.decode_batch(comp, clen, out_cap=BLOCK, engine="scan")
    with recorded_calls() as calls["scan budget"]:
        decode.decode_batch(comp, clen, out_cap=BLOCK, engine="scan",
                            max_units=CUT_UNITS)
    del comp, clen
    with recorded_calls() as calls["scan 2^18"]:
        decode.decode_bytes(native_compress(wide_piece(data)),
                            bitpar.MAX_OUT_CAP, engine="scan", device=device)
    with recorded_calls() as calls["scan multi"]:
        decode.decode_bytes(b"".join(map(native_compress, short_pair(data))),
                            BLOCK, multi_stream=True, engine="scan",
                            device=device)
    piece = data[:STREAM_SIZE]
    with recorded_calls(first_of_shape=True) as calls["stream"]:
        for backend in encode.BACKENDS:
            stream_encode(piece, backend, device)
    with recorded_calls(first_of_shape=True) as calls["stream pools"]:
        for backend in encode.BACKENDS:
            for arr, n in pool_inputs(data):
                stream._best_matches_host(arr, n, backend=backend,
                                          device=device)
    with recorded_calls(first_of_shape=True) as calls["stream_block"]:
        encode.encode_bytes(piece, BLOCK, device=device)
        block_round_trip(data, device)
    torch.cuda.synchronize()
    for path, names in PATH_KERNELS.items():
        called = sorted(k for k, c in calls[path].items() if c)
        if called != sorted(names):
            raise AssertionError(f"{path}: kernels called {called}, listed "
                                 f"{sorted(names)}")

    # context: the library row sort of the first level's keys, which
    # perk_level keeps in shared memory (its line below times that level)
    args, _ = calls["main"]["perk_level"][0]
    keys = pcand.perk_keys_plain(args[0], args[1], args[4])
    log("kernels", f"context: torch.sort of one level's keys "
        f"({'x'.join(map(str, keys.shape))} int32) "
        f"{cuda_ms(lambda: torch.sort(keys, dim=1)):.4f} ms")
    del keys
    # the parse's other store form, JAX's step-major records
    # (decode2._parse_full), on the decode's own inputs: bitwise its plain
    args, kw = calls["main"]["parse"][0]
    got = decode2._parse_full(*args, **kw)
    want = decode2._parse_full_plain(*args, **kw)
    if not all(torch.equal(g, w) for g, w in zip(got, want, strict=True)):
        raise AssertionError("parse: the step-major form differs from plain")
    log("kernels", f"parse's step-major form (_parse_full, "
        f"{'x'.join(map(str, got[0].shape))} records) equal to plain "
        f"(tolerance 0, bitwise)")
    del got, want

    results = {}
    for path, name in PLAIN_TOO_SLOW:
        for args, kw in calls[path].pop(name):
            e = {"path": path, "shape": _shape_key(args, kw), "calls": 1,
                 "numel": 0, **_scan_against_bits(args, kw)}
            results.setdefault(name, {"max_abs_err": 0, "at": []})[
                "at"].append(e)
            log("kernels", f"{path} {name} ({e['shape']}) x1: its decode "
                f"equal to engine bits (tolerance 0, bitwise; the plain "
                f"loop of its {e['steps']} steps is too slow), kernel "
                f"{e['ms']:.4f} ms")
    for path, by_kernel in calls.items():
        for name, recorded in by_kernel.items():
            # time the first and the last call of each set of tensor
            # shapes: the per-k kernels' 11 calls differ only in k
            last = {_tensor_key(a, kw): i
                    for i, (a, kw) in enumerate(recorded)}
            shapes, seen = {}, set()
            for i, (args, kw) in enumerate(recorded):
                key, tkey = _shape_key(args, kw), _tensor_key(args, kw)
                timed = key not in shapes and (tkey not in seen
                                               or i == last[tkey])
                seen.add(tkey)
                r = _compare(name, args, kw, timed)
                entry = shapes.setdefault(key, {
                    "path": path, "shape": key, "calls": 0,
                    "numel": _numel(name, args), **r})
                entry["calls"] += 1
            recorded.clear()
            res = results.setdefault(name, {"max_abs_err": 0, "at": []})
            for e in shapes.values():
                res["at"].append(e)
                times = ("not timed" if "ms" not in e else
                         f"kernel {e['ms']:.4f} ms, plain {e['plain_ms']:.4f} "
                         f"ms, bound {e['bound_ms']:.4f} ms ({e['bound_by']})"
                         + ("" if e["library_ms"] is None else
                            f", library {e['library_ms']:.4f} ms")
                         + ("" if "context" not in e else
                            f"; context: {e['context']['call']} "
                            f"{e['context']['ms']:.4f} ms"))
                log("kernels", f"{path} {name} ({e['shape']}) x{e['calls']}: "
                    f"equal to plain (tolerance 0, bitwise), {times}")
            torch.cuda.empty_cache()
    # the headline time of a kernel: its widest timed input on a counted
    # path (the first such call)
    for res in results.values():
        top = max((e for e in res["at"]
                   if e["path"] in PATH_KERNELS and "ms" in e),
                  key=lambda e: e["numel"])
        res.update({k: top[k] for k in ("shape", "ms", "plain_ms",
                                        "library_ms", "bound_ms",
                                        "bound_by")})
        for e in res["at"]:
            del e["numel"]
    return results


def _stage_breakdown(codec: BlockCodec, data: bytes) -> str:
    """Host-clock ms of each stage of one compress + decompress, timed by
    the pipeline's own spans with a synchronize around each; "other" is
    the rest of the two calls (framing, host copies). Informational."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with trace.stage_times() as times:
        codec.decompress(codec.compress(data))
    wall = time.perf_counter() - t0
    missing = [s for s in trace.STAGES if s not in times]
    if missing:
        raise AssertionError(f"stages not timed: {missing}")
    parts = [f"{s} {1e3 * times[s]:.1f}" for s in trace.STAGES]
    parts.append(f"other {1e3 * (wall - sum(times.values())):.1f}")
    return "stages ms: " + ", ".join(parts)


def phase_main(data: bytes, device: torch.device, native):
    native_compress, native_decompress = native
    codec = BlockCodec(block=BLOCK, device=device)
    _kernels.reset_launches()
    blob = codec.compress(data)
    out = codec.decompress(blob)
    torch.cuda.synchronize()
    counts = _kernels.launch_counts()
    if out != data:
        raise AssertionError("greedy container round trip differs")
    log("main", f"greedy container {len(blob)} bytes, ratio "
        f"{len(blob) / len(data):.4f}, round trip exact, statuses 0")

    # timed second pass (the first one warmed the allocator and caches)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    blob2 = codec.compress(data)
    t1 = time.perf_counter()
    out2 = codec.decompress(blob2)
    t2 = time.perf_counter()
    if blob2 != blob or out2 != data:
        raise AssertionError("second pass differs from the first")
    log("main", f"compress {len(data) / (t1 - t0) / 1e9:.4f} GB/s "
        f"({1e3 * (t1 - t0):.1f} ms), decompress "
        f"{len(data) / (t2 - t1) / 1e9:.4f} GB/s ({1e3 * (t2 - t1):.1f} ms)")
    log("main", _stage_breakdown(codec, data))

    raw = codec.compress(data, container=False)
    pieces = [data[s:s + BLOCK] for s in range(0, len(data), BLOCK)]
    expect = b"".join(native_compress(p) for p in pieces)
    if raw != expect:
        raise AssertionError("raw payload differs from the C encoder's bytes")
    if native_decompress(raw, len(data)) != data:
        raise AssertionError("C decoder does not read back the raw payload")
    log("main", f"raw payload {len(raw)} bytes == C encoder over "
        f"{len(pieces)} blocks; the C decoder reads it back exactly")

    lazy = BlockCodec(block=BLOCK, policy="lazy", device=device)
    lblob = lazy.compress(data)
    if lazy.decompress(lblob) != data or codec.decompress(lblob) != data:
        raise AssertionError("lazy container round trip differs")
    log("main", f"lazy container {len(lblob)} bytes, ratio "
        f"{len(lblob) / len(data):.4f}, round trip exact")
    return counts, blob, codec


def raw_payload(codec: BlockCodec, data: bytes, device: torch.device):
    """The port's raw per-block payload of ``data``: (comp uint8[B, cap],
    clen int32[B]) on the card, and the blocks (uint8[B, block], n)."""
    x_np, lens = pad_blocks(data, codec.block)
    x = torch.from_numpy(x_np).to(device)
    n = torch.from_numpy(lens).to(device)
    comp, clen, _, _, _ = codec.encode_batch(x, n)
    return comp, clen, x, n


def wide_piece(data: bytes) -> bytes:
    """A slice of the corpus just under the raw decoder's 2^18 bound."""
    return data[:bitpar.MAX_OUT_CAP - 1024]


def short_pair(data: bytes) -> tuple[bytes, bytes]:
    """Two short slices of the corpus (the multi-stream decode's)."""
    half = len(data) // 2
    return data[:1000], data[half:half + 3000]


def phase_raw(data: bytes, device: torch.device, native):
    """The raw-stream decoder on the port's own per-block payload; returns
    the launch counts and the decode's host-clock ms."""
    native_compress, _ = native
    codec = BlockCodec(block=BLOCK, device=device)
    comp, clen, x, n = raw_payload(codec, data, device)
    lens = n.tolist()
    torch.cuda.synchronize()
    _kernels.reset_launches()
    out, out_len, markers = codec.decode_batch_raw(comp, clen)
    torch.cuda.synchronize()
    counts = _kernels.launch_counts()
    if out_len.tolist() != lens:
        raise AssertionError("raw decode: output lengths differ")
    if not torch.equal(torch.where(torch.arange(BLOCK, device=device)
                                   < n[:, None], out, 0), x):
        raise AssertionError("raw decode: bytes differ from the input")
    # a full block's end marker lies at out_cap = block, past the output,
    # and is not read (as in the JAX package's scan oracle)
    want_markers = [int(m < BLOCK) for m in lens]
    if markers.tolist() != want_markers:
        raise AssertionError(f"raw decode: markers {markers.tolist()}")
    log("raw", f"decode_batch_raw of {comp.shape[0]} x {comp.shape[1]} "
        f"bytes ({int(clen.sum())} payload): every block equals its input; "
        f"{sum(want_markers)} end marker(s) read, one per block shorter "
        f"than {BLOCK} (a full block's marker lies past out_cap)")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    codec.decode_batch_raw(comp, clen)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    log("raw", f"raw decode {len(data) / dt / 1e9:.4f} GB/s "
        f"({1e3 * dt:.1f} ms, host clock, synchronised)")
    with trace.stage_times() as times:
        codec.decode_batch_raw(comp, clen)
    if set(times) != set(trace.RAW_STAGES):
        raise AssertionError(f"raw stages timed: {sorted(times)}")
    log("raw", "raw stages ms: " + ", ".join(
        f"{s} {1e3 * times[s]:.1f}" for s in trace.RAW_STAGES))
    del comp, out, x

    # short blocks: each reads its end marker on the card
    q = len(data) // 4
    short = [data[s:s + m] for s, m in
             ((0, 1), (q, 1000), (2 * q, 20000), (3 * q, BLOCK - 1))]
    encoded = [raw_payload(codec, p, device)[:2] for p in short]
    comp = torch.cat([c for c, _ in encoded])
    clen = torch.cat([m for _, m in encoded])
    out, out_len, markers = codec.decode_batch_raw(comp, clen)
    got = [bytes(out[i, :int(out_len[i])].cpu().numpy())
           for i in range(len(short))]
    if got != short or markers.tolist() != [1] * len(short):
        raise AssertionError(f"raw decode of short blocks: lengths "
                             f"{out_len.tolist()}, markers "
                             f"{markers.tolist()}")
    log("raw", f"decode_batch_raw of {len(short)} short blocks "
        f"({[len(p) for p in short]} bytes): exact, one end marker each")

    piece = wide_piece(data)
    stream = native_compress(piece)
    out, out_len, markers = decode.decode_block(
        torch.from_numpy(np.frombuffer(stream, np.uint8).copy()).to(device),
        torch.tensor(len(stream), dtype=torch.int32, device=device),
        out_cap=bitpar.MAX_OUT_CAP)
    if (out[:int(out_len)].cpu().numpy().tobytes() != piece
            or int(markers) != 1):
        raise AssertionError("decode_block at out_cap 2^18 differs")
    log("raw", f"decode_block of a {len(stream)}-byte C-encoded stream at "
        f"out_cap {bitpar.MAX_OUT_CAP}: {len(piece)} bytes exact, its end "
        f"marker read")
    return counts, 1e3 * dt


def _prefix_equal(out: torch.Tensor, upto: torch.Tensor,
                  x: torch.Tensor) -> bool:
    """Each row of ``out`` equals ``x``'s before its ``upto`` bytes."""
    keep = torch.arange(out.shape[1], device=out.device) < upto[:, None]
    return torch.equal(torch.where(keep, out, 0), torch.where(keep, x, 0))


def phase_scan(data: bytes, device: torch.device, native,
               raw_ms: float) -> dict[str, int]:
    """The raw decoder's engine "scan" on the raw payload of phase 5, the
    2^18 slice, a multi-stream pair and a budget that cuts every
    stream."""
    native_compress, _ = native
    codec = BlockCodec(block=BLOCK, device=device)
    comp, clen, x, n = raw_payload(codec, data, device)
    bits = codec.decode_batch_raw(comp, clen)
    torch.cuda.synchronize()
    _kernels.reset_launches()
    got = decode.decode_batch(comp, clen, out_cap=BLOCK, engine="scan")
    torch.cuda.synchronize()
    counts = _kernels.launch_counts()
    out, out_len, markers = got
    if not torch.equal(out_len, n) or not _prefix_equal(out, n, x):
        raise AssertionError("scan decode: bytes differ from the input")
    if not all(torch.equal(g, w) for g, w in zip(got, bits, strict=True)):
        raise AssertionError("scan decode differs from engine bits")
    log("scan", f"decode_batch(engine=\"scan\") of {comp.shape[0]} x "
        f"{comp.shape[1]} bytes: every block equals its input; (out, "
        f"out_len, markers) equal engine bits's (tolerance 0, bitwise)")

    def scan():
        return decode.decode_batch(comp, clen, out_cap=BLOCK, engine="scan")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scan()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    max_units = decode.default_max_units(BLOCK)
    recs, _, marks = decode._parse_scan(comp, clen, out_cap=BLOCK,
                                        max_units=max_units)
    longest = int(((recs >= 0).sum(1) + marks).max())
    del recs
    parse_ms = cuda_ms(lambda: decode._parse_scan(
        comp, clen, out_cap=BLOCK, max_units=max_units))
    log("scan", f"scan decode {len(data) / dt / 1e9:.4f} GB/s "
        f"({1e3 * dt:.1f} ms, host clock, synchronised), device "
        f"{cuda_ms(scan):.4f} ms (CUDA events), its parse {parse_ms:.4f} ms "
        f"(the longest stream {longest} steps, "
        f"{1e6 * parse_ms / longest:.1f} ns a step); raw decode, engine "
        f"bits (phase 5): {raw_ms:.1f} ms, host clock")
    with trace.stage_times() as times:
        scan()
    if set(times) != set(trace.SCAN_STAGES):
        raise AssertionError(f"scan stages timed: {sorted(times)}")
    log("scan", "scan stages ms: " + ", ".join(
        f"{s} {1e3 * times[s]:.1f}" for s in trace.SCAN_STAGES))

    cut, cut_len, _ = decode.decode_batch(comp, clen, out_cap=BLOCK,
                                          engine="scan", max_units=CUT_UNITS)
    if not bool((cut_len < n).all()) or not _prefix_equal(cut, cut_len, x):
        raise AssertionError("scan decode at max_units "
                             f"{CUT_UNITS}: not a cut prefix of the input")
    log("scan", f"max_units {CUT_UNITS}: every stream cut "
        f"({int(cut_len.min())}-{int(cut_len.max())} bytes), each a "
        f"prefix of its input")
    del comp, out, x, cut

    piece = wide_piece(data)
    stream = native_compress(piece)
    out, out_len, markers = decode.decode_block(
        torch.from_numpy(np.frombuffer(stream, np.uint8).copy()).to(device),
        torch.tensor(len(stream), dtype=torch.int32, device=device),
        out_cap=bitpar.MAX_OUT_CAP, engine="scan")
    if (out[:int(out_len)].cpu().numpy().tobytes() != piece
            or int(markers) != 1):
        raise AssertionError("scan decode_block at out_cap 2^18 differs")
    log("scan", f"decode_block(engine=\"scan\") of the {len(stream)}-byte "
        f"stream at out_cap {bitpar.MAX_OUT_CAP}: {len(piece)} bytes exact, "
        f"its end marker read")

    pair = short_pair(data)
    chain = b"".join(map(native_compress, pair))
    out, out_len, markers = decode.decode_block(
        torch.from_numpy(np.frombuffer(chain, np.uint8).copy()).to(device),
        torch.tensor(len(chain), dtype=torch.int32, device=device),
        out_cap=BLOCK, multi_stream=True, engine="scan")
    if (out[:int(out_len)].cpu().numpy().tobytes() != b"".join(pair)
            or int(markers) != 2):
        raise AssertionError("scan decode of two streams differs")
    log("scan", f"multi_stream decode of two C-encoded streams "
        f"({[len(q) for q in pair]} bytes): both exact, 2 end markers")
    return counts


def stream_encode(piece: bytes, backend: str, device: torch.device) -> bytes:
    """``piece`` through a StreamCompressor on ``device`` in STREAM_FEED
    feeds."""
    c = stream.StreamCompressor(backend=backend, device=str(device))
    out = bytearray()
    for ofs in range(0, len(piece), STREAM_FEED):
        out += c.feed(piece[ofs:ofs + STREAM_FEED])
    out += c.finish()
    return bytes(out)


def pool_inputs(data: bytes):
    """(int32 bytes, n) of the corpus at each pool of POOLS: n at the pool
    and n = 3/4 of it plus 1 (the same pool, positions past n padded)."""
    for pool in POOLS:
        for n in (pool, pool * 3 // 4 + 1):
            piece = data[pool:pool + n]
            yield np.frombuffer(piece, np.uint8).astype(np.int32), n


def block_round_trip(data: bytes, device: torch.device) -> int:
    """One BLOCK-byte encode_block_sync / decode_block_sync round trip of
    the corpus's second block: exact, status 0 (decode_batch_sync's
    status word of the same records). Returns the compressed bytes."""
    piece = data[BLOCK:2 * BLOCK]
    x = torch.from_numpy(np.frombuffer(piece, np.uint8).copy()).to(device)
    n = torch.tensor(len(piece), dtype=torch.int32, device=device)
    comp, nbytes, sbit, sout, _ = encode.encode_block_sync(x, n)
    out = decode2.decode_block_sync(comp, sbit, sout, n, out_cap=BLOCK)
    _, status = decode2.decode_batch_sync(comp[None], sbit[None], sout[None],
                                          n.reshape(1), out_cap=BLOCK)
    if out.cpu().numpy().tobytes() != piece or int(status[0]) != 0:
        raise AssertionError(f"encode_block_sync / decode_block_sync round "
                             f"trip differs (status {int(status[0])})")
    return int(nbytes)


def _stream_mbps(piece: bytes, backend: str, device: torch.device) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stream_encode(piece, backend, device)
    return len(piece) / (time.perf_counter() - t0) / 1e6


def _slice_feed(piece: bytes, backend: str, device: torch.device) -> None:
    """One fresh compressor fed exactly one slice of the stream's pool:
    one match search of 32768 positions and its host walk."""
    stream.StreamCompressor(backend=backend, device=str(device)).feed(piece)
    torch.cuda.synchronize()


def _slice_busy_ms(piece: bytes, backend: str, device: torch.device):
    """Device busy ms of one slice's match search, from a torch.profiler
    session around one slice (the activities launched inside the
    stream's ``lzs::stream_match`` span; overlapping intervals merged);
    None when the profiler saw no device activity there."""
    sys.path.insert(0, str(ROOT / "scripts"))
    from profile_port import device_summary

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        _slice_feed(piece, backend, device)
    out = ROOT / "build" / "stream_slice_trace.json"
    out.parent.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(out))
    events = json.loads(out.read_text())["traceEvents"]
    out.unlink()
    return device_summary(events)["stages"].get(trace.STREAM_STAGES[0])


def phase_stream(data: bytes, device: torch.device, native):
    """The streaming codec on the card: both backends over the first
    STREAM_SIZE bytes, the decoders, the one-block entry points (counters
    reset just before each of the two runs), the pools against the CPU;
    then the slice's numbers (information). Returns the launch counts of
    the streams and of the one-block entry points."""
    native_compress, _ = native
    piece = data[:STREAM_SIZE]
    expect = native_compress(piece)
    torch.cuda.synchronize()
    _kernels.reset_launches()
    got = {b: stream_encode(piece, b, device) for b in encode.BACKENDS}
    torch.cuda.synchronize()
    counts = _kernels.launch_counts()
    for backend, comp in got.items():
        if comp != expect:
            raise AssertionError(f"stream ({backend}) differs from the C "
                                 f"encoder's one-shot bytes")
    log("stream", f"StreamCompressor(device=\"cuda\") of the corpus's "
        f"first {len(piece)} bytes (depth cut: {len(piece)} of "
        f"{len(data)}; pool {stream._POOL}) in {STREAM_FEED}-byte feeds: "
        f"backends {list(got)} each equal the C encoder's one-shot "
        f"{len(expect)} bytes")
    dec = stream.StreamDecompressor()
    if (dec.feed(expect) != piece
            or stream.decompress_stream(expect, STREAM_FEED) != piece):
        raise AssertionError("stream decode differs from the input")
    log("stream", "StreamDecompressor and decompress_stream (native) give "
        "the input back")

    torch.cuda.synchronize()
    _kernels.reset_launches()
    blocks = encode.encode_bytes(piece, BLOCK, device=device)
    nbytes = block_round_trip(data, device)
    torch.cuda.synchronize()
    block_counts = _kernels.launch_counts()
    want = b"".join(native_compress(piece[s:s + BLOCK])
                    for s in range(0, len(piece), BLOCK))
    if blocks != want:
        raise AssertionError("encode_bytes differs from the C encoder")
    log("stream", f"encode_bytes of the {len(piece)} bytes == the C encoder "
        f"block by block ({len(blocks)} bytes); encode_block_sync / "
        f"decode_block_sync of one {BLOCK}-byte block ({nbytes} bytes): "
        f"exact, status 0")

    for backend in encode.BACKENDS:
        for arr, n in pool_inputs(data):
            on_card = stream._best_matches_host(arr, n, backend=backend,
                                                device=device)
            on_cpu = stream._best_matches_host(arr, n, backend=backend,
                                               device="cpu")
            if not all(np.array_equal(g, w) for g, w in zip(
                    on_card, on_cpu, strict=True)):
                raise AssertionError(f"_best_matches_host ({backend}, n={n})"
                                     f": the card differs from the CPU")
    log("stream", f"_best_matches_host on the card == device=\"cpu\" for "
        f"both backends at pools {list(POOLS)}, n at the pool and 3/4 of it")

    mbps = {b: _stream_mbps(piece, b, device) for b in encode.BACKENDS}
    one = data[:stream._POOL]
    walls = {}
    for backend in encode.BACKENDS:
        _slice_feed(one, backend, device)
        runs = []
        for _ in range(3):
            t0 = time.perf_counter()
            _slice_feed(one, backend, device)
            runs.append(1e3 * (time.perf_counter() - t0))
        walls[backend] = sorted(runs)[1]
    for backend in encode.BACKENDS:
        b = _slice_busy_ms(one, backend, device)
        share = ("not measured (the profiler saw no device activity)"
                 if b is None else f"{1 - b / walls[backend]:.4f}")
        log("stream", f"{backend}: stream {mbps[backend]:.4f} MB/s (wall, "
            f"{len(piece)} bytes); one {stream._POOL}-position slice "
            f"{walls[backend]:.2f} ms wall (median of 3), its match "
            f"search's device busy "
            f"{'not measured' if b is None else f'{b:.4f} ms'}, host share "
            f"of the slice {share}")
    return counts, block_counts


def phase_counts(counts: dict[str, dict[str, int]]) -> None:
    for path, names in PATH_KERNELS.items():
        missing = [k for k in names if counts[path][k] <= 0]
        if missing:
            raise AssertionError(f"kernels not launched on the {path} "
                                 f"path: {missing}")
        log("counts", f"{path}: " + ", ".join(
            f"{k}={v}" for k, v in counts[path].items()))
    idle = [k.name for k in _kernels.KERNELS
            if not any(k.name in names for names in PATH_KERNELS.values())]
    if idle:
        raise AssertionError(f"kernels on no path: {idle}")


def phase_corrupt(blob: bytes, codec: BlockCodec) -> None:
    mut = bytearray(blob)
    mut[len(mut) // 2] ^= 0x10
    try:
        codec.decompress(bytes(mut))
    except ValueError as e:
        log("corrupt", f"flipped payload byte rejected: {e}")
        return
    raise AssertionError("a corrupted container decoded without error")


def main() -> None:
    phase_device()
    device = torch.device("cuda", 0)
    t0 = time.perf_counter()
    data = make_corpus(SIZE)
    digest = hashlib.sha256(data).hexdigest()
    if digest != CORPUS_SHA:
        raise AssertionError(f"corpus drift: {digest}")
    log("corpus", f"{len(data)} bytes, sha256 ok, "
        f"{time.perf_counter() - t0:.1f} s")
    phase_build()
    native = native_codec()
    timing = phase_kernels(data, device, native)
    torch.cuda.empty_cache()
    counts = {}
    counts["main"], blob, codec = phase_main(data, device, native)
    counts["raw"], raw_ms = phase_raw(data, device, native)
    counts["scan"] = phase_scan(data, device, native, raw_ms)
    counts["stream"], counts["stream_block"] = phase_stream(data, device,
                                                            native)
    phase_counts(counts)
    phase_corrupt(blob, codec)
    kernels = [{"name": k.name, "route": "cuda", "source": k.source,
                "replaces": k.replaces,
                "launches": sum(c[k.name] for c in counts.values()),
                **{f"launches_{path}": c[k.name]
                   for path, c in counts.items()},
                **timing[k.name]} for k in _kernels.KERNELS]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
