#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (lzs_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (each prints one line; any failure raises and exits non-zero):

  1. device   require CUDA; print the card's name and power limit as
              nvidia-smi gives them;
  2. build    build and load the four CUDA kernels from csrc/ (nvcc);
  3. kernels  each kernel against its plain torch version on the card, at
              the bench shape (256 blocks x 32768 bytes; record rows of
              38656 slots), on inputs made by the port's own pipeline from
              the frozen 8 MiB corpus; bitwise equality, CUDA-event times;
  4. main     BlockCodec(block=32768, device="cuda") compress + decompress
              of the corpus with every launch counter reset just before;
              the round trip must be exact, the raw payload must equal the
              C encoder's bytes block by block (native/lzs_native.cpp)
              and the C decoder must read it back, the lazy policy must
              round-trip, and one more pass prints each stage's time;
  5. counts   every kernel of the path launched at least once in phase 4;
  6. corrupt  a flipped payload byte raises ValueError.

Then one JSON line with every kernel's name, route, source, the TPU
kernel it replaces, its launches in phase 4, its error and both times,
and last the line {"ok": true, "device": {...}}.

Imports torch, numpy and the port; nothing of jax or of the JAX package.
"""

from __future__ import annotations

import ctypes
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
    _kernels, decode2, encode, pexpand, pext, ppack, psync, sortmatch,
    tokenize)
from lzs_tpu_torch import spec, trace  # noqa: E402

BLOCK = 1 << 15
SIZE = 1 << 23
REPS = 10


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def cuda_ms(fn, reps: int = REPS) -> float:
    """Mean milliseconds of fn() on the card over ``reps`` launches."""
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


def native_codec():
    """The repo's native C++ codec (the C encoder's bytes), built with
    make into the ignored build directory and bound with ctypes."""
    out = ROOT / "build" / "native"
    subprocess.run(["make", "-s", "-C", str(ROOT / "native"),
                    f"BUILD={out}"], check=True, capture_output=True)
    lib = ctypes.CDLL(str(out / "liblzs_native.so"))
    lib.lzs_nat_compress.restype = ctypes.c_size_t
    lib.lzs_nat_compress.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                     ctypes.c_void_p, ctypes.c_size_t]
    lib.lzs_nat_decompress.restype = ctypes.c_size_t
    lib.lzs_nat_decompress.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_size_t,
        ctypes.c_int, ctypes.POINTER(ctypes.c_size_t)]

    def compress(data: bytes) -> bytes:
        cap = spec.compressed_max(len(data)) + 16
        buf = ctypes.create_string_buffer(cap)
        m = lib.lzs_nat_compress(data, len(data), buf, cap)
        if m == ctypes.c_size_t(-1).value:
            raise RuntimeError("native compress overflow")
        return buf.raw[:m]

    def decompress(chain: bytes, out_cap: int) -> bytes:
        """Decode a chain of streams, reading on past each end marker."""
        buf = ctypes.create_string_buffer(out_cap)
        used = ctypes.c_size_t(0)
        m = lib.lzs_nat_decompress(chain, len(chain), buf, out_cap, 1,
                                   ctypes.byref(used))
        return buf.raw[:m]

    return compress, decompress


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


def _compare(name: str, kernel_fn, plain_fn) -> dict:
    """Kernel vs plain on the same inputs: bitwise equal, both timed."""
    got = kernel_fn()
    want = plain_fn()
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = 0
    for g, w in zip(got, want, strict=True):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{name}: kernel {g.dtype}{tuple(g.shape)} "
                                 f"vs plain {w.dtype}{tuple(w.shape)}")
        err = max(err, int((g.long() - w.long()).abs().max()))
    if err != 0:
        raise AssertionError(f"{name}: kernel differs from plain, "
                             f"max abs err {err}")
    ms = cuda_ms(kernel_fn)
    plain_ms = cuda_ms(plain_fn)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def phase_kernels(data: bytes, device: torch.device) -> dict[str, dict]:
    """Each kernel vs its plain version at the bench shape, on inputs the
    port's pipeline makes from the corpus (random rows for the scans)."""
    rng = np.random.default_rng(7)
    x_np, lens = pad_blocks(data, BLOCK)
    x = torch.from_numpy(x_np).to(device).to(torch.int32)
    n = torch.from_numpy(lens).to(device)
    b = x.shape[0]
    results = {}

    def scan_rows(width: int) -> torch.Tensor:
        v = rng.integers(-(1 << 20), 1 << 20, (b, width), dtype=np.int64)
        pick = rng.random((b, width))
        v[pick < 0.2] = -1
        v[pick > 0.8] = 0x3FFFFFFF
        return torch.from_numpy(v.astype(np.int32)).to(device)

    span = encode.SYNC_SPAN
    nslots = encode.sync_slots(BLOCK, span)
    s_fill = -(-(nslots * (span // 32 + 2) * 4) // 128) * 128
    enc_rows = scan_rows(BLOCK)
    fill_rows = scan_rows(s_fill)
    results["rowscan_cummax"] = _compare(
        "cummax", lambda: pext.cummax_rows(fill_rows),
        lambda: pext.cummax_rows_plain(fill_rows))
    results["rowscan_rcummin"] = _compare(
        "rcummin", lambda: pext.rcummin_rows(enc_rows),
        lambda: pext.rcummin_rows_plain(enc_rows))
    log("kernels", f"scans equal on ({b}, {s_fill}) and ({b}, {BLOCK})")

    score, off, full = sortmatch.best_matches_batch(x, n)
    value, width, starts, _ = tokenize.emission_units_batch(
        x, n, score, off, full)
    cap = encode.cap_bytes(BLOCK)
    em = (spec.END_MARKER_VALUE, spec.END_MARKER_BITS)
    results["pack"] = _compare(
        "pack", lambda: ppack.pack_rows(value, width, cap, em),
        lambda: ppack.pack_rows_plain(value, width, cap, em))
    comp, total_bits, offs = ppack.pack_rows(value, width, cap, em)

    end_bits = total_bits - spec.END_MARKER_BITS
    kw = dict(span=span, nibbles=encode.NIBBLES_PER_STEP,
              short_len=spec.MAX_SHORT_LENGTH,
              ext_len=spec.MAX_EXTENDED_LENGTH, nslots=nslots)
    st32 = starts.to(torch.int32)
    results["sync"] = _compare(
        "sync",
        lambda: psync.sync_records(st32, width, off, offs, end_bits, n, **kw),
        lambda: psync.sync_records_plain(st32, width, off, offs, end_bits,
                                         n, **kw))
    sync_bit, sync_out, _ = psync.sync_records(st32, width, off, offs,
                                               end_bits, n, **kw)

    recs, _ = decode2._parse_full(comp, sync_bit, sync_out, span)
    fill = decode2._filled_records(recs)
    if fill.shape[1] != s_fill:
        raise AssertionError(f"record rows {fill.shape[1]} != {s_fill}")
    results["expand"] = _compare(
        "expand", lambda: pexpand.expand_records(fill, n, BLOCK),
        lambda: pexpand.expand_records_plain(fill, n, BLOCK))
    for name, r in results.items():
        log("kernels", f"{name}: equal to plain (tolerance 0, bitwise), "
            f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms")
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


def phase_main(data: bytes, device: torch.device):
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

    native_compress, native_decompress = native_codec()
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


def phase_counts(counts: dict[str, int]) -> None:
    missing = [k for k, v in counts.items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: "
                             f"{missing}")
    log("counts", ", ".join(f"{k}={v}" for k, v in counts.items()))


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
    timing = phase_kernels(data, device)
    counts, blob, codec = phase_main(data, device)
    phase_counts(counts)
    phase_corrupt(blob, codec)
    kernels = [{"name": k.name, "route": "cuda", "source": k.source,
                "replaces": k.replaces, "launches": counts[k.name],
                **timing[k.name]} for k in _kernels.KERNELS]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
