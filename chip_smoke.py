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
              6's, and the first call of each shape of the stream's runs
              (phase 7) and of what phases 8-10 add (the coders' repeat
              inputs, the CLI's two raw decodes on the card and the
              first and last BIG_KEEP of the big raw file's, one
              DistributedCodec compress and decompress), is recorded as
              it runs; each recorded
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
              and the input instead (PLAIN_TOO_SLOW); the scan parse is
              recorded in its filled form (the decode's), and its
              step-major form (JAX's records) is held on the same inputs
              against the plain loop on their CPU copies; then the gram
              kernels at the compress cells' row shapes (GRAM_SHAPES);
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
              must be exact and read its end marker; then the heads
              kernel beside its plain version, bitwise equal, at the
              IPComp burst's shape and at one input window's span
              (heads_timing): kernel ms, bound ms, plain ms;
  6. scan     decode.decode_batch(engine="scan") of the same raw payload,
              with the counters reset just before: every block must equal
              its input, and (out, out_len, markers) engine "bits"'s,
              bitwise; its GB/s (host clock, synchronised) and device ms
              beside phase 5's raw decode; the parse's ns a step (kernel
              time over the longest stream's steps) and its walker's
              clock64 cycles a step, at 256 streams, 132 (one an SM) and
              the longest stream alone; then the 2^18 slice through
              decode_block(engine="scan") (exact, its end marker read,
              the parse's ns and cycles a step),
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
  8. coders   the codec profiles (lzs_tpu_torch.models) on the card, with
              the counters reset just before: each profile's
              compress_bytes of the corpus's first 32768 bytes (one
              compress's whole span) round-trips exactly, "standard"
              equals the C encoder's one-shot bytes, and a block of random
              bytes repeated at periods 2100 and 3000 (matches past offset
              2047) through "reach", "flat" and "bounded" gives the CPU's
              tokens; then each distinct (window, cap) match table on the
              card against device="cpu";
  9. cli      lzs_tpu_torch.cli.main in this process on files under
              build/, counters reset just before: raw blocks of the corpus
              (equal to the C encoder block by block, read back by the C
              decoder), decompress of the first 4 blocks' raw file and of
              the whole raw file (one window of the input, the output
              expanded in windows of 2^18), and of the big raw file (the
              whole raw file repeated past BIG_MIB MiB: windows of the
              input, bitpar._WIN bytes each), all on the card, container
              and lazy container round trips, --stream of the first 1
              MiB (the C encoder's one-shot bytes); each call's
              host-clock MB/s and route, the whole and the big raw
              files' decode stages, and the big file's windows and peak
              device memory; then the long token (a copy whose run of
              2^27 + 2^24 extension nibbles passes 2^26 input bytes,
              2,264,924,173 bytes out) through the CLI's raw decode on
              the card, its length, ends and SHA-256 against the copy
              rule's bytes, its wall, input windows and peak device
              memory;
 10. dist     DistributedCodec(block=32768) on an NCCL world of one
              (a FileStore under build/), counters reset just before: its
              payload and sync arrays equal BlockCodec's, its decompress
              exact; the group is destroyed after;
 11. counts   every kernel of each path launched at least once in that
              path's phase (4-10);
 12. corrupt  a flipped payload byte raises ValueError.

Then one JSON line with every kernel's name, route, source, the TPU
kernel it replaces, its launches in phases 4-10, its error, its
times (kernel, plain, library call or null), its bound and what bounds
it at its widest input on a counted path ("shape"), the same at every
shape (``at``), and last the line {"ok": true, "device": {...}}.

Imports torch, numpy and the port; nothing of jax or of the JAX package.
"""

from __future__ import annotations

import contextlib
import functools
import hashlib
import io
import json
import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

from bench import CORPUS_SHA, make_corpus  # noqa: E402
from lzs_tpu_torch.blocks import BlockCodec, pad_blocks  # noqa: E402
from lzs_tpu_torch.ops import (  # noqa: E402
    _kernels, bitpar, decode, decode2, encode, pcand, pexpand, pext, pgather,
    ppack, psync, pwalk, sortmatch)
from lzs_tpu_torch import cli, parallel, spec, stream, trace  # noqa: E402
from lzs_tpu_torch.models import PROFILES, get_profile  # noqa: E402
from lzs_tpu_torch.utils import native  # noqa: E402

BLOCK = 1 << 15
SIZE = 1 << 23
REPS = 10

#: kernels each path must launch (the counters are reset before each)
PATH_KERNELS = {
    "main": ("gram_keys", "rank_lcp", "perk_level", "ext_breaks",
             "ext_fold", "rank_mask", "gather_big", "rowscan_cummax",
             "rowscan_rcummin", "pack", "sync", "expand", "walk_tables",
             "walk_entries", "walk_descent", "parse"),
    "raw": ("raw_heads", "rowscan_cumsum", "walk_tables",
            "walk_entries", "walk_descent", "rowscan_cummax", "expand"),
    "scan": ("scan_parse", "expand"),
    "stream": ("gram_keys", "rank_lcp", "perk_level", "ext_breaks",
               "ext_fold", "rank_mask", "gather_big", "rowscan_rcummin"),
}
#: the stream phase's one-block entry points (encode_bytes and one
#: encode_block_sync / decode_block_sync round trip) run the main path's
#: encode and decode at batch 1
PATH_KERNELS["stream_block"] = PATH_KERNELS["main"]
#: the codec profiles' match search (batch 1, the stream's kernels; the
#: repeat inputs' runs past the tier-1 span close in a tier-2 round, K7)
PATH_KERNELS["coders"] = PATH_KERNELS["stream"]
#: the CLI: the container and raw-block codecs (the main path), the raw
#: decode (the raw path; past 2^18 output bytes in windows) and --stream
PATH_KERNELS["cli"] = PATH_KERNELS["main"] + tuple(
    k for k in PATH_KERNELS["raw"] if k not in PATH_KERNELS["main"])
#: DistributedCodec on a world of one: the main path's encode and decode
PATH_KERNELS["dist"] = PATH_KERNELS["main"]
#: paths whose recording in phase 3 holds only the calls they add to the
#: other paths' (the coders' repeat inputs, the CLI's raw decodes): their
#: recorded kernels are a subset of their lists
PARTLY_RECORDED = ("coders", "cli")
#: the coders phase's depth: one compress's whole span (the match
#: search's pool)
CODER_SPAN = 1 << 15
#: periods of the coders phase's repeat inputs (a block of random bytes
#: twice): matches at offsets past 2047, in the windows of FAR_PROFILES
REPEATS = (2100, 3000)
FAR_PROFILES = ("reach", "flat", "bounded")
#: the CLI phase's raw file of the corpus's first blocks: its stream
#: (some 53 KB) decodes in one window of the input, its output in one of
#: 2^18
CLI_BLOCKS = 4
#: a scan-engine step budget that cuts every stream of the raw payload
CUT_UNITS = 1000
#: the CLI phase's big raw file passes this many MiB of input (the whole
#: raw file repeated), so that it decodes over several input windows
BIG_MIB = 40
#: the big raw file's kernel calls that phase 3 holds to their plain
#: versions: the first and the last BIG_KEEP of each kernel's (the
#: windows of the input repeat their shapes; the plain walk's entries at
#: a window's 524,544 tiles take some 20 s)
BIG_KEEP = 3
#: the CLI phase's long token: a copy of offset 1 whose run of
#: extension nibbles (2^26 + 2^23 input bytes) passes 2^26 bytes, and
#: whose output passes 2^31 bytes; it decodes in input windows that each
#: cut the run
LONG_NIBBLES = (1 << 27) + (1 << 24)
#: the raw decoder's kernels, which the long token's decode launches
RAW_KERNELS = ("raw_heads", "rowscan_cummax", "rowscan_cumsum",
               "walk_tables", "walk_entries", "walk_descent", "expand")
#: the heads kernel's timed shapes beside its plain version: the IPComp
#: burst's rows (HEADS_ROWS x HEADS_ROW_BYTES, the streams of 1 KiB blocks
#: of the corpus) and one input window's span of the big raw file
HEADS_ROWS = 8192
HEADS_ROW_BYTES = 2048
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
    "gram_keys": (sortmatch, "gram_keys", sortmatch.gram_keys_plain),
    "rank_lcp": (sortmatch, "rank_lcp", sortmatch.rank_lcp_plain),
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
    "scan_parse": (decode, "_parse_scan_filled",
                   decode._parse_scan_filled_plain),
    "raw_heads": (bitpar, "_heads", bitpar._heads_plain),
}

#: kernels whose plain version runs once per comparison, whose own call
#: is then its timed call: the scan parse's plain loop issues some 45
#: launches a parse step, seconds at the payload's 17,000-step streams;
#: the walk entries' plain loop some 9 a tile, over 10 s at the CLI's
#: whole raw file (262,144 tiles)
ONE_SHOT = {"scan_parse", "walk_entries"}

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
#: (add, the exclusive difference); gather_big 2 (the clamp); gram_keys 24
#: (a 12-byte gram: 11 shifts and 11 ors over its bytes, two sign flips);
#: rank_lcp 9 (the key0 XOR, its leading zeros and their bytes, the tie
#: test, the same three and an add for key1, the cap); perk_level 37:
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
#: 8: bit position, count, mode, offset, markers, done); raw_heads 38 per
#: bit position (the window 1, the nibble chain 4: the nibble, its fit,
#: the continue test and the recurrence's step; the head's fields 12, as
#: scan_parse's; its width and the chain's entry 4, the chain's value at
#: the head's end 1, the fit 2, the length 3, the successor 6, the step
#: 2, the low bits 3)
#: the scan parse's serial bound, a bound of its design (one walker a
#: stream) and not of the work, which a parallel parse (engine "bits") is
#: not held to: so it stands on phase scan's lines, not as ``bound_ms``.
#: Its longest stream's steps times one step's dependent chain in its
#: walker, from one bit position to the next (scripts/sass_loop.py --dump:
#: the funnel shift, the offset form's bit taken out (shift, mask, test),
#: the two width selects, the add, the window's advance test and its
#: select: 9 SASS instructions), each at the latency of a dependent
#: funnel shift or add that one thread reads with clock64 in this run
#: (``decode._chain_latency``), at the card's highest SM clock
SCAN_CHAIN_INSTRUCTIONS = 9
OPS_PER_ELEMENT = {
    "gram_keys": 24, "rank_lcp": 9, "perk_level": 5 + 14 + 18, "ext_breaks": 41, "ext_fold": 17,
    "rank_mask": 2, "gather_big": 2,
    "rowscan_cummax": 1, "rowscan_rcummin": 1, "rowscan_cumsum": 1,
    "walk_tables": 21, "walk_entries": 3 / 128, "walk_descent": 22 / 7,
    "pack": 8, "sync": 18, "expand": 4, "parse": 50, "scan_parse": 35,
    "raw_heads": 38,
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
    if name == "rank_lcp":
        # s0 and perm read and plcp and p written at every rank; key1 read
        # only at the ranks of a tie on the first 8 bytes
        s0, key1, perm = args[:3]
        touched = 0
        if key1 is not None:
            tie = s0[:, 1:] == s0[:, :-1]
            near = torch.zeros_like(s0, dtype=torch.bool)
            near[:, 1:] |= tie
            near[:, :-1] |= tie
            touched = int(near.sum()) * key1.element_size()
        return 24 * s0.numel() + touched
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
        if g is None and w is None:       # gram_keys' key1 of a short gram
            continue
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{name}: kernel {g.dtype}{tuple(g.shape)} "
                                 f"vs plain {w.dtype}{tuple(w.shape)}")
        if g.numel():
            err = max(err, int((g.long() - w.long()).abs().max()))
            if not torch.equal(g, w):     # an int64 difference that wraps
                err = max(err, 1)
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


def _scan_steps(outs: tuple, longest: bool = False) -> int:
    """The parse steps a scan parse's streams took (or, with ``longest``,
    its longest stream), counted as its records with output plus its end
    markers (a zero extension nibble, the one other step without output,
    is not counted): in the filled rows a record is where the row
    rises."""
    fill, _, markers = outs
    per = ((fill[:, :1] >= 0).sum(1) + (fill[:, 1:] > fill[:, :-1]).sum(1)
           + markers)
    return int(per.max() if longest else per.sum())


def sm_clock_hz() -> float:
    """The card's highest SM clock, as nvidia-smi gives it."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True)
    return 1e6 * float(smi.stdout.strip().splitlines()[0])


def _scan_against_bits(args: tuple, kw: dict) -> dict:
    """A scan parse call held against engine "bits" instead of the plain
    loop (PLAIN_TOO_SLOW): its records, filled and expanded, must give
    the bits engine's (out, out_len, markers) on the same input, bitwise;
    its kernel time beside."""
    fill, out_len, markers = decode._parse_scan_filled(*args, **kw)
    out, _ = pexpand.expand_records(fill, out_len, kw["out_cap"])
    want = decode.decode_batch(*args, out_cap=kw["out_cap"],
                               multi_stream=kw["multi_stream"])
    if not all(torch.equal(g, w) for g, w in zip(
            (out, out_len, markers), want, strict=True)):
        raise AssertionError("scan_parse: the decode differs from engine "
                             "bits")
    return {"max_abs_err": 0, "held_against": "engine bits",
            "steps": _scan_steps((fill, out_len, markers)),
            "ms": cuda_ms(lambda: decode._parse_scan_filled(*args, **kw))}


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
    parse: lane-substeps, B x L x 4 (span/32 + 2); raw_heads: bit
    positions, B x nbits)."""
    if name == "gather_big":
        return args[1].numel()
    if name == "raw_heads":
        return args[0].shape[0] * args[2]
    if name == "parse":
        return args[1].numel() * 4 * (args[3] // 32 + 2)
    return next(a.numel() for a in args if torch.is_tensor(a))


def phase_kernels(data: bytes, device: torch.device, native) -> dict:
    """Each kernel's wrapper vs its plain version, bitwise, on every input
    that the paths give it, recorded as they run: one greedy compress +
    decompress of the corpus (path main), one decode_batch_raw of its raw
    per-block payload (path raw) and the 2^18 decode_block (path raw,
    wide row), the scan decodes, the stream, and the first call of each
    shape of what the last three paths add: the profiles' repeat inputs
    (coders), the CLI's raw decodes on the card (cli) and one
    DistributedCodec compress and decompress (dist). The first and last
    call of each shape is timed with CUDA events."""
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
    with recorded_calls(first_of_shape=True) as calls["coders"]:
        for name in FAR_PROFILES:
            for period in REPEATS:
                get_profile(name, device=str(device)).compress(
                    repeat_block(period))
    with recorded_calls(first_of_shape=True) as calls["cli"]:
        chains = cli_raw_chains(data, native_compress)
        for chain in chains:
            cli._decompress_raw_device(chain, device)
    with recorded_calls(first_of_shape=True) as big:
        cli._decompress_raw_device(big_raw(chains[1])[0], device)
    for name, recorded in big.items():
        keep = (recorded if len(recorded) <= 2 * BIG_KEEP
                else recorded[:BIG_KEEP] + recorded[-BIG_KEEP:])
        calls["cli"][name].extend(keep)
    del big, chains
    with (world_of_one(device),
          recorded_calls(first_of_shape=True) as calls["dist"]):
        dist_drive(data, device)
    torch.cuda.synchronize()
    for path, names in PATH_KERNELS.items():
        called = sorted(k for k, c in calls[path].items() if c)
        if not (set(called) <= set(names) if path in PARTLY_RECORDED
                else called == sorted(names)) or not called:
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
    # the scan parse's other store form, JAX's step-major records
    # (decode._parse_scan), on the scan decodes' inputs: bitwise its plain
    # loop, run on the inputs' CPU copies (the loop's some 45 small calls
    # a step cost a third of their launches on the card)
    for path in ("scan", "scan budget", "scan multi"):
        args, kw = calls[path]["scan_parse"][0]
        got = decode._parse_scan(*args, **kw)
        want = decode._parse_scan_plain(*(a.cpu() for a in args), **kw)
        if not all(torch.equal(g.cpu(), w)
                   for g, w in zip(got, want, strict=True)):
            raise AssertionError(f"scan_parse ({path}): the step-major "
                                 "form differs from plain")
        log("kernels", f"{path} scan_parse's step-major form (_parse_scan, "
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
                                        "bound_by")
                    if k in top})
        for e in res["at"]:
            del e["numel"]
    return results


#: the gram kernels' timed row shapes beyond the paths': the benchmark's
#: compress cells (a 32 MiB file's blocks, the IPComp burst's payload
#: rows, the sessions' history-and-packet rows)
GRAM_SHAPES = ((1024, 32768), (8192, 1500), (8192, 3547))


def gram_timing(data: bytes, device: torch.device) -> None:
    """gram_keys and rank_lcp beside their plain versions at GRAM_SHAPES,
    on rows cut from the corpus (zero past 9/10 of each row): bitwise
    equal, then kernel, bound and plain ms (CUDA events)."""
    cap = spec.SEARCH_MATCH_MAX
    for b, npos in GRAM_SHAPES:
        flat = np.frombuffer((data * (b * npos // len(data) + 1))[:b * npos],
                             np.uint8).reshape(b, npos).astype(np.int32)
        flat[:, npos * 9 // 10:] = 0
        x = torch.from_numpy(flat).to(device)
        s0, key1, perm = sortmatch.gram_sort(x, cap)
        for name, args in (("gram_keys", (x, cap)),
                           ("rank_lcp", (s0, key1, perm, cap))):
            e = _compare(name, args, {}, True)
            log("kernels", f"{name} at {b} x {npos}: equal to plain "
                f"(tolerance 0, bitwise), kernel {e['ms']:.4f} ms, plain "
                f"{e['plain_ms']:.4f} ms, bound {e['bound_ms']:.4f} ms "
                f"({e['bound_by']})")
        del x, s0, key1, perm
        torch.cuda.empty_cache()


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
    heads_timing(data, device, native_compress)
    return counts, 1e3 * dt


def heads_timing(data: bytes, device: torch.device, native_compress) -> None:
    """The heads kernel (bitpar._heads) beside its plain version at the
    IPComp burst's shape (HEADS_ROWS rows of HEADS_ROW_BYTES, each the
    port's stream of a 1 KiB block of the corpus, zero past it) and at one
    input window's span of the big raw file (one row of _WIN + _MARGIN
    bytes, the input going on past it): bitwise equal, then the kernel's
    ms, its bound and the plain version's ms (CUDA events)."""
    codec = BlockCodec(block=1024, device=device)
    comp, clen, _, _ = raw_payload(codec, data[:HEADS_ROWS * 1024], device)
    width = min(comp.shape[1], HEADS_ROW_BYTES)
    keep = torch.arange(width, device=device) < clen[:, None]
    rows = torch.zeros((comp.shape[0], HEADS_ROW_BYTES), dtype=torch.uint8,
                       device=device)
    rows[:, :width] = torch.where(keep, comp[:, :width], 0)
    span = bitpar._WIN + bitpar._MARGIN
    big = big_raw(cli_raw_chains(data, native_compress)[1])[0][:span]
    one = torch.from_numpy(np.frombuffer(big, np.uint8).copy()).to(device)
    for label, comp, inbits, cap in (
            ("the burst's rows", rows, 8 * clen.to(torch.int32), 1024),
            ("one input window's span", one[None],
             torch.tensor([8 * (span + 4)], dtype=torch.int32,
                          device=device), bitpar._NO_CAP)):
        b, nbits = comp.shape[0], 8 * comp.shape[1]
        args = (comp, inbits[:, None], nbits, cap, False)
        got, want = bitpar._heads(*args), bitpar._heads_plain(*args)
        if not all(torch.equal(g, w) for g, w in zip(got, want,
                                                     strict=True)):
            raise AssertionError(f"raw_heads at {label} differs from plain")
        del got, want
        bytes_ms = 1e3 * (comp.numel() + 13 * b * nbits) / MEMORY_BYTES_PER_S
        ops_ms = (1e3 * OPS_PER_ELEMENT["raw_heads"] * b * nbits
                  / INT32_OPS_PER_S)
        log("raw", f"raw_heads at {label} ({b} x {comp.shape[1]} bytes): "
            f"equal to plain (tolerance 0, bitwise), kernel "
            f"{cuda_ms(lambda: bitpar._heads(*args)):.4f} ms, bound "
            f"{max(bytes_ms, ops_ms):.4f} ms ("
            f"{'bytes' if bytes_ms >= ops_ms else 'operations'}), plain "
            f"{cuda_ms(lambda: bitpar._heads_plain(*args)):.4f} ms")
        torch.cuda.empty_cache()


def _prefix_equal(out: torch.Tensor, upto: torch.Tensor,
                  x: torch.Tensor) -> bool:
    """Each row of ``out`` equals ``x``'s before its ``upto`` bytes."""
    keep = torch.arange(out.shape[1], device=out.device) < upto[:, None]
    return torch.equal(torch.where(keep, out, 0), torch.where(keep, x, 0))


def scan_step_costs(comp: torch.Tensor, clen: torch.Tensor,
                    out_cap: int) -> dict:
    """The scan parse's cost a step on ``comp`` at the default budget: its
    filled form's kernel time (CUDA events) over the longest stream's
    steps (records with output plus end markers, as JAX's step records
    count them), and its walker's clock64 cycles over its own steps, for
    the stream that walked the most (``top``)."""
    kw = {"out_cap": out_cap, "max_units": decode.default_max_units(out_cap)}
    longest = _scan_steps(decode._parse_scan_filled(comp, clen, **kw),
                          longest=True)
    ms = cuda_ms(lambda: decode._parse_scan_filled(comp, clen, **kw))
    stats = decode._scan_walker_stats(comp, clen, **kw).cpu()
    top = int(stats[:, 1].argmax())
    cycles, steps = (int(v) for v in stats[top])
    link = decode._chain_latency(comp.device)
    chain = SCAN_CHAIN_INSTRUCTIONS * link
    serial = 1e3 * longest * chain / sm_clock_hz()
    return {"top": top, "line": (
        f"{comp.shape[0]} x {comp.shape[1]} bytes: {ms:.4f} ms (CUDA "
        f"events), the longest stream {longest} steps, "
        f"{1e6 * ms / longest:.2f} ns a step; its walker {cycles} cycles "
        f"over {steps} steps, {cycles / steps:.2f} cycles a step "
        f"(clock64); serial bound {serial:.4f} ms "
        f"({SCAN_CHAIN_INSTRUCTIONS} dependent instructions x {link:.3f} "
        f"cycles, the latency read in this run, = {chain:.2f} "
        f"cycles a step)")}


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
    costs = scan_step_costs(comp, clen, BLOCK)
    log("scan", f"scan decode {len(data) / dt / 1e9:.4f} GB/s "
        f"({1e3 * dt:.1f} ms, host clock, synchronised), device "
        f"{cuda_ms(scan):.4f} ms (CUDA events); raw decode, engine bits "
        f"(phase 5): {raw_ms:.1f} ms, host clock")
    log("scan", "its parse, " + costs["line"])
    # two walkers on one SM (256 streams on 132 SMs) against one (132
    # streams), and the longest stream alone
    top = costs["top"]
    for label, rows in (("132 streams", slice(0, 132)),
                        ("the longest stream alone", slice(top, top + 1))):
        log("scan", f"its parse, {label}: "
            + scan_step_costs(comp[rows], clen[rows], BLOCK)["line"])
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
    wide = torch.from_numpy(np.frombuffer(stream, np.uint8).copy()).to(
        device)[None]
    wlen = torch.tensor([len(stream)], dtype=torch.int32, device=device)
    log("scan", "its parse: "
        + scan_step_costs(wide, wlen, bitpar.MAX_OUT_CAP)["line"])

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


def repeat_block(period: int) -> bytes:
    """``period`` random bytes (seed 0), twice: from ``period`` on every
    position matches at offset ``period``."""
    rng = np.random.default_rng(0)
    return rng.integers(0, 256, period, dtype=np.uint8).tobytes() * 2


def coders_drive(data: bytes, device) -> tuple[dict, dict]:
    """Every profile's compress_bytes of the corpus's first CODER_SPAN
    bytes, and the FAR_PROFILES' tokens of each repeat input, with the
    match search on ``device``."""
    piece = data[:CODER_SPAN]
    blobs = {name: get_profile(name, device=str(device)).compress_bytes(
        piece) for name in PROFILES}
    far = {(name, period): get_profile(name, device=str(device)).compress(
        repeat_block(period)) for name in FAR_PROFILES for period in REPEATS}
    return blobs, far


def phase_coders(data: bytes, device: torch.device, native):
    """The generalized coders on the card: the profiles of
    ``lzs_tpu_torch.models`` (counters reset just before), each round
    trip exact, ``standard`` equal to the C encoder, the repeat inputs'
    tokens equal to the CPU's; then each distinct (window, cap) match
    table on the card against the CPU's."""
    native_compress, _ = native
    piece = data[:CODER_SPAN]
    torch.cuda.synchronize()
    _kernels.reset_launches()
    t0 = time.perf_counter()
    blobs, far = coders_drive(data, device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _kernels.launch_counts()
    for name, blob in blobs.items():
        if get_profile(name, device=str(device)).decompress_bytes(
                blob) != piece:
            raise AssertionError(f"profile {name}: round trip differs")
    if blobs["standard"] != native_compress(piece):
        raise AssertionError("profile standard differs from the C encoder")
    log("coders", f"{len(PROFILES)} profiles' compress_bytes of "
        f"{len(piece)} bytes on the card: each round trip exact, "
        f"standard == the C encoder's one-shot bytes; sizes " + ", ".join(
            f"{k} {len(v)}" for k, v in blobs.items()))
    for (name, period), toks in far.items():
        cpu = get_profile(name, device="cpu")
        block = repeat_block(period)
        if toks != cpu.compress(block) or cpu.decompress(toks) != block:
            raise AssertionError(f"profile {name}, period {period}: tokens "
                                 f"differ from the CPU's")
    longest = max((t for t in far[("flat", REPEATS[-1])] if t[0] == "match"),
                  key=lambda t: t[2])
    log("coders", f"repeat inputs (periods {list(REPEATS)}) through "
        f"{list(FAR_PROFILES)}: tokens == device=\"cpu\"'s, round trips "
        f"exact (flat, period {REPEATS[-1]}: longest match {longest})")
    arr = np.frombuffer(piece, np.uint8).astype(np.int32)
    pairs = sorted({(c.window, c.search_cap) for c in PROFILES.values()})
    for window, cap in pairs:
        got, want = (stream._best_matches_host(arr, len(piece), window=window,
                                               cap=cap, device=dev)
                     for dev in (device, "cpu"))
        if not all(np.array_equal(g, w) for g, w in zip(got, want,
                                                         strict=True)):
            raise AssertionError(f"_best_matches_host (window {window}, cap "
                                 f"{cap}): the card differs from the CPU")
    mbps = len(PROFILES) * len(piece) / wall / 1e6
    log("coders", f"match tables on the card == device=\"cpu\" at "
        f"(window, cap) {pairs}; the profiles and repeats {mbps:.4f} MB/s of "
        f"profile input (host clock, information)")
    return counts


def cli_raw_chains(data: bytes, native_compress) -> tuple[bytes, bytes]:
    """The raw files the CLI phase decodes: the C encoder's blocks of the
    corpus's first CLI_BLOCKS blocks, and of the whole corpus (what the
    CLI's compress writes, which phase 9 checks)."""
    blocks = [native_compress(data[s:s + BLOCK])
              for s in range(0, len(data), BLOCK)]
    return b"".join(blocks[:CLI_BLOCKS]), b"".join(blocks)


def big_raw(raw: bytes) -> tuple[bytes, int]:
    """The big raw file: ``raw`` repeated past BIG_MIB MiB (a chain of
    streams is a raw file), and its repeats."""
    reps = (BIG_MIB << 20) // len(raw) + 1
    return raw * reps, reps


def long_token_file(nibbles: int) -> tuple[bytes, int]:
    """A raw file of one long token, and the a's it decodes to (then one
    b): a literal a, a copy of offset 1 with length code 1111,
    ``nibbles`` extension nibbles of 15 and the end nibble 3, a literal b
    and an end marker, bit by bit at its ends and 0xff bytes between. Its
    token is 8 + 15 * nibbles + 3 bytes, each the one before it."""
    head = "0" + format(ord("a"), "08b") + "11" + "0000001" + "1111"
    fill = -len(head) % 8
    whole, rest = divmod(4 * nibbles - fill, 8)
    end = "1" * rest + "0011" + "0" + format(ord("b"), "08b") + "110000000"
    end += "0" * (-len(end) % 8)

    def pack(bits: str) -> bytes:
        return int(bits, 2).to_bytes(len(bits) // 8, "big")

    data = (pack(head + "1" * fill) + np.full(whole, 0xFF, np.uint8).tobytes()
            + pack(end))
    return data, 1 + 8 + 15 * nibbles + 3


def repeated_sha256(n: int, tail: bytes) -> str:
    """The SHA-256 of n a's and then ``tail``, fed from one numpy chunk."""
    chunk = np.full(1 << 26, ord("a"), np.uint8)
    h = hashlib.sha256()
    for s in range(0, n, len(chunk)):
        h.update(chunk[:min(len(chunk), n - s)])
    h.update(tail)
    return h.hexdigest()


def long_token_drive(device: torch.device, card: str) -> None:
    """The long token's file through the CLI's raw decode on the card:
    its length, ends and SHA-256 against the bytes that the copy rule
    gives (built with numpy, no decoder), and its wall, input windows,
    peak device memory and launches of the raw decoder's kernels
    printed. Its kernel calls are not recorded in phase 3: its input
    windows take the big raw file's spans (one row of _WIN + _MARGIN
    bytes) and its output windows rows of 2^18 bytes, as the big file's
    do."""
    data, n = long_token_file(LONG_NIBBLES)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    launched = _kernels.launch_counts()
    t0 = time.perf_counter()
    out, windows = windows_taken(
        lambda: cli._decompress_raw_device(data, device))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) - before
    counts = _kernels.launch_counts()
    if len(out) != n + 1 or out[:1] != b"a" or out[-2:] != b"ab":
        raise AssertionError(f"cli decompress long token: {len(out)} bytes, "
                             f"not {n + 1}, or its ends differ")
    digest = hashlib.sha256(out).hexdigest()
    if digest != repeated_sha256(n, b"b"):
        raise AssertionError("cli decompress long token: sha256 differs")
    del out
    idle = [k for k in RAW_KERNELS if counts[k] == launched[k]]
    if idle:
        raise AssertionError(f"cli decompress long token: {idle} did not "
                             f"launch")
    log("cli", f"decompress long token: {len(data)} bytes in (a run of "
        f"{LONG_NIBBLES} extension nibbles), {n + 1} bytes out, sha256 "
        f"{digest[:16]}... == the copy rule's; {windows} input windows of "
        f"{bitpar._WIN} bytes, wall {dt:.3f} s ({(n + 1) / dt / 1e6:.4f} "
        f"MB/s of output, host clock), peak device memory "
        f"{peak / 2**30:.3f} GiB over what was allocated before it (its "
        f"input included), on {card}; launches "
        + ", ".join(f"{k}={counts[k] - launched[k]}" for k in RAW_KERNELS))


def windows_taken(fn):
    """fn()'s result and the input windows it took (calls of
    ``bitpar._heads``, one a window)."""
    calls = [0]
    heads = bitpar._heads

    def count(*args, **kw):
        calls[0] += 1
        return heads(*args, **kw)

    bitpar._heads = count
    try:
        return fn(), calls[0]
    finally:
        bitpar._heads = heads


def cli_drive(data: bytes, work: pathlib.Path, device: torch.device,
              native) -> dict:
    """The CLI's calls on files under ``work`` (cli.main in this
    process, ``--device`` the card): (a) raw blocks of the corpus, (b)
    decompress of its first CLI_BLOCKS blocks' raw file, (c) of the whole
    raw file, (d) of the big raw file, (e) container and lazy container
    round trips, (f) --stream of the first STREAM_SIZE bytes. Returns
    ({call: (seconds, stderr)}, the big file's repeats, input windows and
    peak device memory less what was allocated before it)."""
    native_compress, _ = native
    src = work / "corpus.bin"
    src.write_bytes(data)
    (work / "slice.bin").write_bytes(data[:STREAM_SIZE])
    pieces = [data[s:s + BLOCK] for s in range(0, CLI_BLOCKS * BLOCK, BLOCK)]
    head = sum(len(native_compress(p)) for p in pieces)
    calls = {}

    def run(name: str, *argv: str) -> None:
        err = io.StringIO()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(err):
            rc = cli.main([*argv, "--device", str(device)])
        torch.cuda.synchronize()
        if rc != 0:
            raise AssertionError(f"cli {name}: exit code {rc}")
        calls[name] = (time.perf_counter() - t0, err.getvalue())

    run("compress", "compress", "-v", str(src), str(work / "raw.lzs"))
    (work / "head.lzs").write_bytes((work / "raw.lzs").read_bytes()[:head])
    run("decompress head", "decompress", "-v", str(work / "head.lzs"),
        str(work / "head.out"))
    run("decompress", "decompress", "-v", str(work / "raw.lzs"),
        str(work / "raw.out"))
    chain, reps = big_raw((work / "raw.lzs").read_bytes())
    (work / "big.lzs").write_bytes(chain)
    del chain
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    _, windows = windows_taken(lambda: run(
        "decompress big", "decompress", "-v", str(work / "big.lzs"),
        str(work / "big.out")))
    big = {"reps": reps, "windows": windows,
           "peak": torch.cuda.max_memory_allocated(device) - before}
    for name, flags in (("container", ()), ("container lazy", ("--lazy",))):
        run(f"compress {name}", "compress", "--container", *flags, "-v",
            str(src), str(work / f"{name}.lzst"))
        run(f"decompress {name}", "decompress", "-v",
            str(work / f"{name}.lzst"), str(work / f"{name}.out"))
    run("compress stream", "compress", "--stream", "-v",
        str(work / "slice.bin"), str(work / "slice.lzs"))
    return calls, big


def _route(stderr: str) -> str:
    return next(line.split(": ", 1)[1] for line in stderr.splitlines()
                if line.startswith("route: "))


def phase_cli(data: bytes, device: torch.device, native,
              card: str) -> dict[str, int]:
    """The CLI in this process on temporary files under build/ (counters
    reset just before): every output checked against the C codec or the
    input, each call's host-clock MB/s and route printed (information),
    then the long token's raw decode."""
    native_compress, native_decompress = native
    with tempfile.TemporaryDirectory(dir=build_dir()) as tmp:
        work = pathlib.Path(tmp)
        torch.cuda.synchronize()
        _kernels.reset_launches()
        calls, big = cli_drive(data, work, device, native)
        long_token_drive(device, card)
        torch.cuda.synchronize()
        counts = _kernels.launch_counts()
        raw = (work / "raw.lzs").read_bytes()
        expect = b"".join(native_compress(data[s:s + BLOCK])
                          for s in range(0, len(data), BLOCK))
        if raw != expect or native_decompress(raw, len(data)) != data:
            raise AssertionError("cli compress: raw blocks differ from the C "
                                 "encoder, or the C decoder does not read "
                                 "them back")
        for name, out, plain, route in (
                ("decompress head", "head.out", data[:CLI_BLOCKS * BLOCK],
                 "device"),
                ("decompress", "raw.out", data, "device"),
                ("decompress big", "big.out", data * big["reps"], "device"),
                ("decompress container", "container.out", data,
                 "device, container"),
                ("decompress container lazy", "container lazy.out", data,
                 "device, container")):
            if (work / out).read_bytes() != plain:
                raise AssertionError(f"cli {name}: output differs")
            if _route(calls[name][1]) != route:
                raise AssertionError(f"cli {name}: route "
                                     f"{_route(calls[name][1])!r}, not "
                                     f"{route!r}")
        if (work / "slice.lzs").read_bytes() != native_compress(
                data[:STREAM_SIZE]):
            raise AssertionError("cli --stream differs from the C encoder's "
                                 "one-shot bytes")
        sizes = {"compress": len(data), "decompress head": CLI_BLOCKS * BLOCK,
                 "decompress big": big["reps"] * len(data),
                 "compress stream": STREAM_SIZE}
        for name, (dt, err) in calls.items():
            size = sizes.get(name, len(data))
            route = (f", route {_route(err)}" if "route: " in err else "")
            log("cli", f"{name}: {size / dt / 1e6:.4f} MB/s ({1e3 * dt:.1f} "
                f"ms, host clock){route}")
        with trace.stage_times() as times:
            cli._decompress_raw_device(raw, device)
        if set(times) != set(trace.RAW_STAGES):
            raise AssertionError(f"raw stages timed: {sorted(times)}")
        log("cli", f"the whole raw file's decode ({len(raw)} bytes in, "
            f"windows of {bitpar.MAX_OUT_CAP}), stages ms: " + ", ".join(
                f"{s} {1e3 * times[s]:.1f}" for s in trace.RAW_STAGES))
        chain = (work / "big.lzs").read_bytes()
        with trace.stage_times() as times:
            cli._decompress_raw_device(chain, device)
        dt = calls["decompress big"][0]
        log("cli", f"the big raw file ({len(chain)} bytes in, the whole raw "
            f"file x{big['reps']}, {big['reps'] * len(data)} out): "
            f"{big['windows']} input windows of {bitpar._WIN} bytes, peak "
            f"device memory {big['peak'] / 2**30:.3f} GiB over the input's, "
            f"{big['reps'] * len(data) / dt / 1e6:.4f} MB/s of output "
            f"({1e3 * dt:.1f} ms, host clock); stages ms: " + ", ".join(
                f"{s} {1e3 * times[s]:.1f}" for s in trace.RAW_STAGES))
        if big["windows"] < 2:
            raise AssertionError("cli decompress big: one input window")
    log("cli", f"raw blocks == the C encoder, read back by the C decoder; "
        f"the first {CLI_BLOCKS} blocks' raw file, the whole raw file (past "
        f"2^18 output bytes, in windows) and the big raw file (past "
        f"{BIG_MIB} MiB of input, in windows of the input) decoded on the "
        f"card; container and lazy container round trips exact; --stream "
        f"== the C encoder's one-shot bytes")
    return counts


def build_dir() -> pathlib.Path:
    """The checkout's ignored build directory (temporary files go there)."""
    path = ROOT / "build"
    path.mkdir(exist_ok=True)
    return path


@contextlib.contextmanager
def world_of_one(device: torch.device):
    """The default process group as a world of one (NCCL on the card; a
    FileStore under build/), destroyed on exit."""
    with tempfile.TemporaryDirectory(dir=build_dir()) as tmp:
        parallel.initialize_distributed(f"file://{tmp}/store", 1, 0,
                                        device_type=device.type)
        try:
            yield
        finally:
            torch.distributed.destroy_process_group()


def dist_drive(data: bytes, device: torch.device):
    """(codec, its compress of ``data``, the decompress of that) with
    DistributedCodec on the default group's mesh."""
    codec = parallel.DistributedCodec(parallel.make_block_mesh(device.type),
                                      block=BLOCK)
    comp = codec.compress(data)
    return codec, comp, codec.decompress(*comp[:4], pad_blocks(data, BLOCK)[1])


def _median_walls(calls: dict, runs: int = 3) -> dict[str, float]:
    """Median host-clock ms (synchronised) of each call, run in turns."""
    walls = {name: [] for name in calls}
    for _ in range(runs):
        for name, fn in calls.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls[name].append(1e3 * (time.perf_counter() - t0))
    return {name: sorted(w)[len(w) // 2] for name, w in walls.items()}


def phase_dist(data: bytes, device: torch.device) -> dict[str, int]:
    """DistributedCodec on an NCCL world of one (counters reset just
    before): its payload and sync arrays equal BlockCodec's on the card,
    and its decompress is exact; then both codecs' compress walls, in
    turns (information)."""
    codec = BlockCodec(block=BLOCK, device=device)
    with world_of_one(device):
        torch.cuda.synchronize()
        _kernels.reset_launches()
        dcodec, (payload, clens, sbit, sout, nsync), out = dist_drive(
            data, device)
        torch.cuda.synchronize()
        counts = _kernels.launch_counts()
        walls = _median_walls({
            "DistributedCodec": lambda: dcodec.compress(data),
            "BlockCodec": lambda: codec.compress(data, container=False)})
    x, lens = pad_blocks(data, BLOCK)
    _, want_clen, want_sbit, want_sout, want_nsync = (
        t.cpu().numpy() for t in codec.encode_batch(
            torch.from_numpy(x).to(device), torch.from_numpy(lens).to(device)))
    if payload != codec.compress(data, container=False):
        raise AssertionError("dist payload differs from BlockCodec's")
    for name, got, want in (("clens", np.asarray(clens), want_clen),
                            ("sbit", sbit, want_sbit),
                            ("sout", sout, want_sout),
                            ("nsync", nsync, want_nsync)):
        if not np.array_equal(got, want):
            raise AssertionError(f"dist {name} differs from BlockCodec's")
    if out != data:
        raise AssertionError("dist round trip differs")
    log("dist", f"DistributedCodec(block={BLOCK}) on an NCCL world of "
        f"{dcodec.ndev}: payload ({len(payload)} bytes), clens, sbit, sout "
        f"and nsync == BlockCodec on the card; decompress exact")
    log("dist", "compress wall ms (host clock, median of 3, in turns): "
        + ", ".join(f"{k} {v:.2f}" for k, v in walls.items()))
    return counts


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
    card = phase_device()
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
    gram_timing(data, device)
    counts = {}
    counts["main"], blob, codec = phase_main(data, device, native)
    counts["raw"], raw_ms = phase_raw(data, device, native)
    counts["scan"] = phase_scan(data, device, native, raw_ms)
    counts["stream"], counts["stream_block"] = phase_stream(data, device,
                                                            native)
    counts["coders"] = phase_coders(data, device, native)
    counts["cli"] = phase_cli(data, device, native, card)
    counts["dist"] = phase_dist(data, device)
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
