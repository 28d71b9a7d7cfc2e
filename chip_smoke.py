#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (lzs_tpu_torch): every path
at full width, every kernel call held bitwise to its plain version, each
kernel's time beside its bound.

Run from the root of a checkout, on a machine with one CUDA device:

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):

  1. device  the card's name and power limit, as nvidia-smi gives them;
  2. paths   each path of ``PATH_KERNELS`` on the frozen 8 MiB corpus
             (``DRIVES``), its outputs checked as it runs, with the launch
             counters reset before it and every kernel wrapper call
             recorded (``recorded_calls``; the paths of
             ``FIRST_OF_SHAPE`` record each kernel's first call of each
             set of shapes, since their slices and windows repeat them):
             main          BlockCodec(block=32768) compress + decompress,
                           exact, and a second compress of the same bytes
                           that must give the same container;
             raw           decode_batch_raw of the raw per-block payload
                           (the C encoder's bytes block by block) and one
                           decode_block of a C-encoded slice just under
                           2^18 bytes, both exact;
             scan          decode_batch(engine="scan") of that payload,
                           equal to engine "bits", and again with a step
                           budget that cuts every stream (each block a
                           prefix of its input);
             stream        StreamCompressor on 1 MiB in 64 KiB feeds, both
                           backends, equal to the C encoder's one-shot
                           bytes and read back by decompress_stream;
             stream_block  encode_bytes of that 1 MiB (the C encoder's
                           blocks) and one encode_block_sync /
                           decode_block_sync round trip, status 0;
             coders        every profile's compress_bytes of one 32 KiB
                           block (round trips; "standard" is the C
                           encoder's bytes), and repeat inputs with
                           matches past offset 2047 through the far
                           profiles (the CPU's tokens);
             cli           cli.main on files: raw blocks (the C
                           encoder's), their decompress, the raw file
                           repeated past 40 MiB (windows of the input),
                           container and lazy container round trips, and
                           --stream, every decompress on the card's route;
             dist          DistributedCodec on an NCCL world of one:
                           BlockCodec's payload, an exact decompress;
             each path must launch exactly the kernels of its list, and a
             match search (main, stream) perk_level 11 times,
             gram_keys, rank_lcp, ext_breaks and ext_fold once, and
             probe_span once a probe wave, as rank_mask;
  3. replay  every recorded call held to the kernel's plain version on the
             same inputs, bitwise; the first and the last call of each set
             of tensor shapes timed with CUDA events beside its bound
             (``bound``: bytes over the memory peak or int32 operations
             over the int32 peak, from ``portbench/roofline.py``);
  4. corrupt a flipped container byte raises ValueError.

Then one JSON line {"kernels": [...]}: each kernel's name, source, the TPU
kernel it replaces, its launches on each path, and, at its widest timed
call, the shape, ms, bound_ms and bound_by, with every timed shape under
``at``; and last the line {"ok": true, "device": {...}}.
``scripts/kernel_bench.py`` times chosen kernels in more detail on the
same recorded calls. Imports nothing of jax or of the JAX package.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import pathlib
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

from bench import CORPUS_SHA, make_corpus  # noqa: E402
from lzs_tpu_torch.blocks import BlockCodec, pad_blocks  # noqa: E402
from lzs_tpu_torch.ops import (  # noqa: E402
    _kernels, bitpar, decode, decode2, encode, pcand, pexpand, pext, pgather,
    ppack, psync, pwalk, sortmatch)
from lzs_tpu_torch import cli, parallel, stream  # noqa: E402
from lzs_tpu_torch.models import PROFILES, get_profile  # noqa: E402
from lzs_tpu_torch.utils import native  # noqa: E402
from portbench import roofline  # noqa: E402
from portbench.roofline import INT32_OPS_PER_S, MEMORY_BYTES_PER_S  # noqa: E402

BLOCK = 1 << 15
SIZE = 1 << 23
#: CUDA-event timing: calls a timed shape
REPS = 10

#: the raw decoder's kernels (engine "bits")
RAW_KERNELS = ("raw_heads", "rowscan_cummax", "rowscan_cumsum",
               "walk_tables", "walk_entries", "walk_descent", "expand")
#: the kernels each path launches, and no others
PATH_KERNELS = {
    "main": ("gram_keys", "rank_lcp", "perk_level", "ext_breaks",
             "ext_fold", "rank_mask", "probe_span", "gather_big",
             "rowscan_cummax",
             "rowscan_rcummin", "pack", "sync", "expand", "walk_tables",
             "walk_entries", "walk_descent", "parse"),
    "raw": RAW_KERNELS,
    "scan": ("scan_parse", "expand"),
    "stream": ("gram_keys", "rank_lcp", "perk_level", "ext_breaks",
               "ext_fold", "rank_mask", "probe_span", "gather_big",
               "rowscan_rcummin"),
}
#: the one-block entry points and DistributedCodec run the main path's
#: encode and decode at batch 1 and on a mesh; the codec profiles run the
#: stream's match search; the CLI runs the container and raw-block codecs,
#: the raw decode and --stream
PATH_KERNELS["stream_block"] = PATH_KERNELS["main"]
PATH_KERNELS["coders"] = PATH_KERNELS["stream"]
PATH_KERNELS["cli"] = tuple(dict.fromkeys(PATH_KERNELS["main"]
                                          + RAW_KERNELS))
PATH_KERNELS["dist"] = PATH_KERNELS["main"]
#: paths that record each kernel's first call of each set of shapes only
FIRST_OF_SHAPE = ("stream", "stream_block", "coders", "cli", "dist")

#: a match search's launches of each kernel, at the search cap's 11
#: levels (k = 2 .. 12); the probe tier's kernels follow its waves:
#: probe_span and rank_mask once a wave, gather_big once a wave (the
#: delivery) and once a tier-2 round
SEARCH_LAUNCHES = {"gram_keys": 1, "rank_lcp": 1, "perk_level": 11,
                   "ext_breaks": 1, "ext_fold": 1}
#: the stream path's depth cut, feed and the coders' block
STREAM_SIZE = 1 << 20
STREAM_FEED = 1 << 16
#: periods of the coders' repeat inputs (a block of random bytes twice):
#: matches at offsets past 2047, in the windows of FAR_PROFILES
REPEATS = (2100, 3000)
FAR_PROFILES = ("reach", "flat", "bounded")
#: a scan-engine step budget that cuts every stream of the raw payload
CUT_UNITS = 1000
#: the CLI's big raw file passes this many MiB of input, so that it
#: decodes over several input windows
BIG_MIB = 40

#: each kernel's wrapper (module, attribute) and its plain version
WRAPPERS = {
    "gram_keys": (sortmatch, "gram_keys", sortmatch.gram_keys_plain),
    "rank_lcp": (sortmatch, "rank_lcp", sortmatch.rank_lcp_plain),
    "perk_level": (pcand, "perk_level", pcand.perk_level_plain),
    "ext_breaks": (pext, "ext_breaks", pext.ext_breaks_plain),
    "ext_fold": (pext, "ext_fold", pext.ext_fold_plain),
    "rank_mask": (pext, "rank_mask", pext.rank_mask_plain),
    "probe_span": (sortmatch, "probe_span", sortmatch.probe_span_plain),
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

#: The fewest int32 operations a function needs per element (expand: per
#: output byte; gather_big: per query; probe_span: per live lane; parse:
#: per lane-substep;
#: scan_parse: per parse step, counted as the records with output plus
#: the end markers; raw_heads: per bit position; else per element of the
#: first operand), counted from its definition and not from a kernel's
#: code. ``portbench.roofline.OPS_PER_ELEMENT`` holds them all but the
#: four of ``OWN_OPS``; the reasons for each: a row scan 1 (its
#: operator); rank_mask 2 (add, the exclusive difference); gather_big 2
#: (the clamp); perk_level 37: the keys 5 (compare, select, max, shift,
#: or), the row sort 14 (a comparison sort of N keys needs log2(N!)
#: compares, 13.56 per key at N = 32768, rounded up; bound by bytes either
#: way) and the fold 18 (unpack 2 keys 5, window and segment tests 4, hit
#: 4, pack 4, max 1); ext_breaks 41 (capped and head 11, break info 7,
#: min 1, next break, steal and probe 14, pack 8); ext_fold 17;
#: walk_tables 21 (7 table levels, a composition and a freeze test each);
#: walk_entries 3 per tile of 128 exits; walk_descent 22 per position over
#: its 7 table entries; pack 8 per unit (offset, word, shift, two-word
#: OR); sync 18 per unit; expand 4 per byte (its record, the source, a
#: load, a store); parse 50 per lane-substep (the 24-bit window of the
#: two-word register 9, the can test 4, the cheaper of the two decodes, a
#: run of extension nibbles, 15, the record and the state update 22);
#: scan_parse 35 per step (the window at the bit position 3, the input
#: left 1, the head's fields 12 (flag, offset form, offset, length code,
#: long test, length), its width and the gate 5, the length cut to the
#: output left 2, the record 4, the state update 8); gram_keys 24 per
#: position (a 12-byte gram: 11 shifts and 11 ors over its bytes, two
#: sign flips); rank_lcp 9 per rank (the key0 XOR, its leading zeros and
#: their bytes, the tie test, the same three and an add for key1, the
#: cap); raw_heads 38 per bit position (the window 1, the nibble chain 4:
#: the nibble, its fit, the continue test and the recurrence's step; the
#: head's fields 12, as scan_parse's; its width and the chain's entry 4,
#: the chain's value at the head's end 1, the fit 2, the length 3, the
#: successor 6, the step 2, the low bits 3). Roofline's raw heads stage
#: counts 14 a bit for the same function (ROADMAP D1). probe_span 30 per
#: live lane (the key's position, offset and its floor 3; cbase, a and
#: bpos 4; the XORs of the two spans' 12 words 12; the first word that
#: differs and its leading equal bytes 3; the count 2; the clip to n 3;
#: the tier-2 test 3); an empty lane needs its key's test alone.
OWN_OPS = {"gram_keys": 24, "rank_lcp": 9, "raw_heads": 38,
           "probe_span": 30}
OPS_PER_ELEMENT = {**roofline.OPS_PER_ELEMENT, **OWN_OPS}


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


@contextlib.contextmanager
def recorded_calls(first_of_shape: bool = False):
    """Record the arguments of every kernel wrapper call made inside, by
    kernel name (the wrappers run as usual); with ``first_of_shape`` only
    each kernel's first call of each set of shapes."""
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


def _shape_key(args: tuple, kw: dict) -> str:
    """The shapes of a call's tensors and its other arguments."""
    def one(a):
        return "x".join(map(str, a.shape)) if torch.is_tensor(a) else repr(a)
    return ", ".join([one(a) for a in args]
                     + [f"{k}={one(v)}" for k, v in sorted(kw.items())])


def _tensor_key(args: tuple, kw: dict) -> str:
    """The shapes of a call's tensors alone (the per-k kernels' calls
    differ only in k)."""
    return ", ".join("x".join(map(str, a.shape))
                     for a in (*args, *kw.values()) if torch.is_tensor(a))


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
    if name == "probe_span":
        # a key read and cln and dact written per lane, n per row, and each
        # x entry that a live lane's two 48-byte spans touch read once
        x, n, srt, cap = args
        npos = x.shape[1]
        live = srt != sortmatch._NO_LANE
        row = live.nonzero()[:, 0]
        key = srt[live]
        a = ((key >> 15) + cap).clamp(max=npos - 1)
        bpos = a - torch.minimum((key & 0x7FFF).clamp(min=1), a)
        t = torch.arange(4 * sortmatch._T1_WORDS, device=srt.device)
        pos = torch.cat([a[:, None] + t, bpos[:, None] + t], 1)
        flat = (row[:, None] * npos + pos)[pos < npos]
        return 12 * srt.numel() + 4 * n.numel() + 4 * torch.unique(
            flat).numel()
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


def _elements(name: str, args: tuple, outs: tuple) -> int:
    """The elements that a call's operation count is per (see
    ``OPS_PER_ELEMENT``; parse's lane-substeps are B x L x 4 (span/32 +
    2); in scan_parse's filled rows a record is where the row rises)."""
    if name == "expand":
        return outs[0].numel()
    if name == "scan_parse":
        fill, _, markers = outs
        return int((fill[:, :1] >= 0).sum() + (fill[:, 1:] > fill[:, :-1])
                   .sum() + markers.sum())
    if name == "gather_big":
        return args[1].numel()
    if name == "probe_span":
        return int((args[2] != sortmatch._NO_LANE).sum())
    if name == "raw_heads":
        return args[0].shape[0] * args[2]
    if name == "parse":
        return args[1].numel() * 4 * (args[3] // 32 + 2)
    return next(a.numel() for a in args if torch.is_tensor(a))


def bound(name: str, args: tuple, kw: dict, outs: tuple) -> dict:
    """The call's least time on an H100 and what bounds it."""
    bytes_ms = 1e3 * _bytes_moved(name, args, kw, outs) / MEMORY_BYTES_PER_S
    ops_ms = (1e3 * OPS_PER_ELEMENT[name] * _elements(name, args, outs)
              / INT32_OPS_PER_S)
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def event_ms(fn, reps: int = REPS) -> float:
    """Mean CUDA-event ms of ``reps`` back-to-back calls, after one."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def _as_tuple(out) -> tuple:
    return out if isinstance(out, tuple) else (out,)


def raw_payload(codec: BlockCodec, data: bytes, device: torch.device):
    """The port's raw per-block payload of ``data``: (comp uint8[B, cap],
    clen int32[B]) on the card."""
    x_np, lens = pad_blocks(data, codec.block)
    x = torch.from_numpy(x_np).to(device)
    n = torch.from_numpy(lens).to(device)
    comp, clen, _, _, _ = codec.encode_batch(x, n)
    return comp, clen


def wide_piece(data: bytes) -> bytes:
    """A slice of the corpus just under the raw decoder's 2^18 bound."""
    return data[:bitpar.MAX_OUT_CAP - 1024]


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def _blocks(data: bytes) -> bytes:
    """The C encoder's raw blocks of ``data``."""
    return b"".join(native.compress(data[s:s + BLOCK])
                    for s in range(0, len(data), BLOCK))


def _main(data, device, work):
    codec = BlockCodec(block=BLOCK, device=device)

    def run():
        blob = codec.compress(data)
        _check(codec.decompress(blob) == data, "main: round trip differs")
        _check(codec.compress(data) == blob,
               "main: a second compress differs from the first")
    return run


def _raw(data, device, work):
    codec = BlockCodec(block=BLOCK, device=device)
    comp, clen = raw_payload(codec, data, device)
    rows = comp.cpu().numpy()
    _check(b"".join(r[:c].tobytes() for r, c in zip(rows, clen.tolist()))
           == _blocks(data),
           "raw: the payload differs from the C encoder's blocks")
    wide = native.compress(wide_piece(data))

    def run():
        out, out_len, _ = codec.decode_batch_raw(comp, clen)
        _check(b"".join(r[:c].tobytes() for r, c in zip(
            out.cpu().numpy(), out_len.tolist())) == data,
               "raw: decode_batch_raw differs from the input")
        _check(decode.decode_bytes(wide, bitpar.MAX_OUT_CAP, device=device)
               == wide_piece(data), "raw: the 2^18 decode_block differs")
    return run


def _scan(data, device, work):
    codec = BlockCodec(block=BLOCK, device=device)
    comp, clen = raw_payload(codec, data, device)
    want = decode.decode_batch(comp, clen, out_cap=BLOCK)

    def run():
        got = decode.decode_batch(comp, clen, out_cap=BLOCK, engine="scan")
        _check(all(torch.equal(g, w) for g, w in zip(got, want, strict=True)),
               "scan: engine scan differs from engine bits")
        cut, cut_len, _ = decode.decode_batch(
            comp, clen, out_cap=BLOCK, engine="scan", max_units=CUT_UNITS)
        _check(bool((cut_len < want[1]).all()), "scan: a stream not cut")
        keep = torch.arange(BLOCK, device=device) < cut_len[:, None]
        _check(torch.equal(torch.where(keep, cut, 0),
                           torch.where(keep, want[0], 0)),
               "scan: a cut stream is not a prefix of its block")
    return run


def _stream(data, device, work):
    piece = data[:STREAM_SIZE]
    want = native.compress(piece)

    def run():
        for backend in encode.BACKENDS:
            c = stream.StreamCompressor(backend=backend, device=str(device))
            out = bytearray()
            for ofs in range(0, len(piece), STREAM_FEED):
                out += c.feed(piece[ofs:ofs + STREAM_FEED])
            out += c.finish()
            _check(bytes(out) == want,
                   f"stream {backend}: differs from the C encoder")
        _check(stream.decompress_stream(want) == piece,
               "stream: decompress_stream differs")
    return run


def _stream_block(data, device, work):
    piece = data[:STREAM_SIZE]
    block = data[BLOCK:2 * BLOCK]
    x = torch.from_numpy(np.frombuffer(block, np.uint8).copy()).to(device)
    n = torch.tensor(len(block), dtype=torch.int32, device=device)

    def run():
        _check(encode.encode_bytes(piece, BLOCK, device=device)
               == _blocks(piece), "stream_block: encode_bytes differs")
        comp, _, sbit, sout, _ = encode.encode_block_sync(x, n)
        out = decode2.decode_block_sync(comp, sbit, sout, n, out_cap=BLOCK)
        _, status = decode2.decode_batch_sync(
            comp[None], sbit[None], sout[None], n.reshape(1), out_cap=BLOCK)
        _check(out.cpu().numpy().tobytes() == block
               and status.tolist() == [0],
               "stream_block: the sync round trip differs")
    return run


def _repeat_block(period: int) -> bytes:
    """``period`` random bytes (seed 0), twice."""
    rng = np.random.default_rng(0)
    return rng.integers(0, 256, period, dtype=np.uint8).tobytes() * 2


def _coders(data, device, work):
    piece = data[:BLOCK]

    def run():
        for name in PROFILES:
            codec = get_profile(name, device=str(device))
            blob = codec.compress_bytes(piece)
            _check(codec.decompress_bytes(blob) == piece,
                   f"coders {name}: round trip differs")
            _check(name != "standard" or blob == native.compress(piece),
                   "coders standard: differs from the C encoder")
        for name in FAR_PROFILES:
            for period in REPEATS:
                block = _repeat_block(period)
                _check(get_profile(name, device=str(device)).compress(block)
                       == get_profile(name, device="cpu").compress(block),
                       f"coders {name}, period {period}: tokens differ")
    return run


def _cli(data, device, work):
    src = work / "corpus.bin"
    src.write_bytes(data)
    (work / "slice.bin").write_bytes(data[:STREAM_SIZE])

    def main(*argv: str) -> str:
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            _check(cli.main([*argv, "--device", str(device)]) == 0,
                   f"cli {argv[0]}: nonzero exit")
        return err.getvalue()

    def decompress(name: str, route: str) -> bytes:
        _check(f"route: {route}\n" in main(
            "decompress", "-v", str(work / name), str(work / "out")),
            f"cli {name}: not route {route}")
        return (work / "out").read_bytes()

    def run():
        main("compress", "--block", str(BLOCK), str(src),
             str(work / "raw.lzs"))
        raw = (work / "raw.lzs").read_bytes()
        _check(raw == _blocks(data), "cli: raw blocks differ")
        _check(decompress("raw.lzs", "device") == data,
               "cli: raw decompress differs")
        reps = (BIG_MIB << 20) // len(raw) + 1
        (work / "big.lzs").write_bytes(raw * reps)
        _check(decompress("big.lzs", "device") == data * reps,
               "cli: the big raw file differs")
        for flags in ((), ("--lazy",)):
            main("compress", "--container", "--block", str(BLOCK), *flags,
                 str(src), str(work / "box.lzst"))
            _check(decompress("box.lzst", "device, container") == data,
                   f"cli container {flags}: round trip differs")
        main("compress", "--stream", str(work / "slice.bin"),
             str(work / "slice.lzs"))
        _check((work / "slice.lzs").read_bytes()
               == native.compress(data[:STREAM_SIZE]), "cli --stream differs")
    return run


def _dist(data, device, work):
    want = BlockCodec(block=BLOCK, device=device).compress(data,
                                                           container=False)

    def run():
        parallel.initialize_distributed(f"file://{work}/store", 1, 0,
                                        device_type=device.type)
        try:
            codec = parallel.DistributedCodec(
                parallel.make_block_mesh(device.type), block=BLOCK)
            payload, clens, sbit, sout, _ = codec.compress(data)
            _check(codec.decompress(payload, clens, sbit, sout,
                                    pad_blocks(data, BLOCK)[1]) == data,
                   "dist: round trip differs")
        finally:
            torch.distributed.destroy_process_group()
        _check(payload == want, "dist: payload differs from BlockCodec's")
    return run


#: each path's setup: (data, device, a scratch directory) -> its run,
#: which drives the path and checks its outputs
DRIVES = {"main": _main, "raw": _raw, "scan": _scan, "stream": _stream,
          "stream_block": _stream_block, "coders": _coders, "cli": _cli,
          "dist": _dist}


def check_launches(path: str, counts: dict[str, int]) -> None:
    """The path launched exactly its kernels; a match search its levels
    and its one call of the others, and its probe tier a span compare and
    a rank a wave, with at least the wave's delivery gather."""
    launched = sorted(k for k, v in counts.items() if v)
    _check(launched == sorted(PATH_KERNELS[path]),
           f"{path}: launched {launched}, listed "
           f"{sorted(PATH_KERNELS[path])}")
    if path in ("main", "stream"):
        searches = counts["gram_keys"]
        _check(all(counts[k] == v * searches
                   for k, v in SEARCH_LAUNCHES.items())
               and counts["probe_span"] == counts["rank_mask"]
               and counts["gather_big"] >= counts["rank_mask"],
               f"{path}: {searches} searches launched {counts}")


def run_paths(paths, data: bytes, device: torch.device):
    """Each path's recorded kernel calls and launch counts."""
    calls, counts = {}, {}
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    for path in paths:
        with tempfile.TemporaryDirectory(dir=build) as tmp:
            run = DRIVES[path](data, device, pathlib.Path(tmp))
            torch.cuda.synchronize()
            _kernels.reset_launches()
            with recorded_calls(path in FIRST_OF_SHAPE) as calls[path]:
                run()
            torch.cuda.synchronize()
        counts[path] = _kernels.launch_counts()
        check_launches(path, counts[path])
        log("paths", f"{path}: outputs exact; launches " + ", ".join(
            f"{k}={v}" for k, v in counts[path].items() if v))
    return calls, counts


def replay(name: str, args: tuple, kw: dict, timed: bool) -> dict:
    """Kernel against plain on one recorded call's inputs, bitwise; if
    asked, the kernel's time and bound."""
    module, attr, plain = WRAPPERS[name]
    wrapper = getattr(module, attr)
    got = _as_tuple(wrapper(*args, **kw))
    want = _as_tuple(plain(*args, **kw))
    for g, w in zip(got, want, strict=True):
        # gram_keys' key1 is None where the gram fits in key0
        _check(g is w is None or (g.dtype == w.dtype and torch.equal(g, w)),
               f"{name}: kernel differs from plain at {_shape_key(args, kw)}")
    out = {"elements": _elements(name, args, got)}
    if timed:
        out.update(ms=event_ms(lambda: wrapper(*args, **kw)),
                   **bound(name, args, kw, got))
    return out


def phase_replay(calls: dict) -> dict:
    """Every recorded call held to plain; the first and last call of each
    set of tensor shapes timed. Returns each kernel's timed shapes."""
    timing = {name: [] for name in WRAPPERS}
    for path, by_kernel in calls.items():
        for name, recorded in by_kernel.items():
            last = {_tensor_key(a, kw): i for i, (a, kw) in enumerate(recorded)}
            shapes, seen = {}, set()
            for i, (args, kw) in enumerate(recorded):
                key, tkey = _shape_key(args, kw), _tensor_key(args, kw)
                timed = key not in shapes and (tkey not in seen
                                               or i == last[tkey])
                seen.add(tkey)
                r = replay(name, args, kw, timed)
                e = shapes.setdefault(key, {"path": path, "shape": key,
                                            "calls": 0, **r})
                e["calls"] += 1
            recorded.clear()
            for e in shapes.values():
                timing[name].append(e)
                times = ("" if "ms" not in e else
                         f", {e['ms']:.4f} ms, bound {e['bound_ms']:.4f} ms "
                         f"({e['bound_by']})")
                log("replay", f"{path} {name} ({e['shape']}) x{e['calls']}: "
                    f"equal to plain (bitwise){times}")
            torch.cuda.empty_cache()
    return timing


def phase_corrupt(data: bytes, device: torch.device) -> None:
    codec = BlockCodec(block=BLOCK, device=device)
    mut = bytearray(codec.compress(data))
    mut[len(mut) // 2] ^= 0x10
    try:
        codec.decompress(bytes(mut))
    except ValueError as e:
        log("corrupt", f"flipped payload byte rejected: {e}")
        return
    raise AssertionError("a corrupted container decoded without error")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)
    device = torch.device("cuda", 0)
    data = make_corpus(SIZE)
    _check(hashlib.sha256(data).hexdigest() == CORPUS_SHA, "corpus drift")
    calls, counts = run_paths(DRIVES, data, device)
    idle = [k.name for k in _kernels.KERNELS
            if not any(counts[p][k.name] for p in counts)]
    _check(not idle, f"kernels on no path: {idle}")
    timing = phase_replay(calls)
    phase_corrupt(data, device)
    kernels = []
    for k in _kernels.KERNELS:
        at = timing[k.name]
        top = max((e for e in at if "ms" in e), key=lambda e: e["elements"])
        kernels.append({
            "name": k.name, "source": k.source, "replaces": k.replaces,
            "launches": {p: c[k.name] for p, c in counts.items()},
            **{f: top[f] for f in ("shape", "ms", "bound_ms", "bound_by")},
            "at": at})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
