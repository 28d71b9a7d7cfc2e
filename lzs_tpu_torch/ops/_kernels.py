"""Build, load and launch the port's hand-written CUDA kernels.

Every ``lzs_tpu_torch/csrc/*.cu`` compiles with ``nvcc`` for ``sm_90a``
(one ``nvcc`` per source, all started together) and links into ONE
shared library with a plain C interface, at first use, under
``build/lzs_tpu_torch/`` in the checkout (the file name carries a hash of
the sources and flags, so an edited source rebuilds). The library is
loaded with ``ctypes``; every pointer and the stream pass as
``c_void_p``.

Each C entry point launches on the stream it is given (PyTorch's current
stream), allocates nothing, and returns ``cudaGetLastError()``; the
:class:`Kernel` wrapper raises :class:`KernelError` when that is not 0
and counts one launch otherwise. Nothing falls back: a failed build or
launch raises.

The module imports no CUDA toolchain: the CPU tests import it and never
build.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

import torch

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "lzs_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int

# C entry points: symbol -> argument types (the device index and the
# stream are the last two arguments of every one).
_SIGNATURES = {
    "lzs_cummax_rows": [_P, _P, _I, _I, _I, _P, _I],
    "lzs_rcummin_rows": [_P, _P, _I, _I, _I, _P, _I],
    "lzs_cumsum_rows": [_P, _P, _I, _I, _I, _P, _I],
    "lzs_rank_mask_rows": [_P, _P, _I, _I, _I, _P, _I],
    "lzs_gather_rows": [_P, _P, _P, _I, _I, _I],
    "lzs_perk_level": [_P, _P, _P, _P, _P, _I, _I, _I, _I],
    "lzs_ext_breaks": [_P, _P, _P, _P, _I, _I, _I, _I, _P, _I],
    "lzs_ext_fold": [_P, _P, _P, _P, _I, _I, _I, _I, _P, _I],
    "lzs_walk_tables": [_P, _P, _P, _I, _I],
    "lzs_walk_entries": [_P, _P, _I, _I],
    "lzs_walk_descent": [_P, _P, _P, _P, _I, _I, _I],
    "lzs_pack_rows": [_P, _P, _I, _I, _P, _I, _P, _P, _I, _I, _I],
    "lzs_sync_rows": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                      _P, _P, _P],
    "lzs_expand_rows": [_P, _P, _I, _I, _P, _I, _P],
    "lzs_parse_lanes": [_P, _P, _P, _I, _I, _I, _I, _P, _I, _P],
    "lzs_scan_parse": [_P, _P, _I, _I, _I, _I, _I, _P, _I, _P, _P],
    "lzs_raw_heads": [_P, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                      _P, _I],
    "lzs_gram_keys": [_P, _P, _P, _I, _I, _I],
    "lzs_rank_lcp": [_P, _P, _P, _P, _P, _I, _I, _I, _I],
    "lzs_probe_span": [_P, _P, _P, _P, _P, _I, _I, _I, _I],
}


class KernelError(RuntimeError):
    """A kernel failed to build or to launch."""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = pathlib.Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise KernelError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda)")
    return str(path)


def sources() -> list[pathlib.Path]:
    """The kernel sources that build into the library."""
    return sorted(CSRC.glob("*.cu"))


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


class _Library:
    """The compiled kernel library, built and loaded once per process."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._lib: ctypes.CDLL | None = None
        self.path: pathlib.Path | None = None

    def get(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                self._lib = self._load()
            return self._lib

    def _load(self) -> ctypes.CDLL:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        so = BUILD_DIR / f"liblzs_tpu_torch_{_source_hash()}.so"
        if not so.exists():
            self._build(so)
        lib = ctypes.CDLL(str(so))
        for name, args in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = [*args, _I, _P]
            fn.restype = ctypes.c_int
        lib.lzs_error_string.argtypes = [ctypes.c_int]
        lib.lzs_error_string.restype = ctypes.c_char_p
        for k in KERNELS:
            k.fn = getattr(lib, k.symbol)
        self.path = so
        return lib

    @staticmethod
    def _build(so: pathlib.Path) -> None:
        """Compile every source at once, one nvcc each, then link."""
        nvcc = _nvcc()
        work = so.with_suffix(f".{os.getpid()}.d")
        work.mkdir(exist_ok=True)
        jobs = []
        try:
            for src in sources():
                obj = work / f"{src.stem}.o"
                cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o",
                       str(obj), str(src)]
                jobs.append((src, obj, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                    text=True)))
            errors = []
            for src, _, proc in jobs:       # wait for every one of them
                _, err = proc.communicate()
                if proc.returncode != 0:
                    errors.append(f"{src.name} ({proc.returncode}):\n"
                                  f"{err[-4000:]}")
            if errors:
                raise KernelError("nvcc failed: " + "\n".join(errors))
            tmp = work / so.name
            res = subprocess.run(
                [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                 *(str(obj) for _, obj, _ in jobs)],
                capture_output=True, text=True)
            if res.returncode != 0:
                raise KernelError(f"nvcc link failed ({res.returncode}):\n"
                                  f"{res.stderr[-4000:]}")
            os.replace(tmp, so)
        finally:
            for _, _, proc in jobs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
            shutil.rmtree(work, ignore_errors=True)


LIBRARY = _Library()


class Kernel:
    """One C entry point of the kernel library and its launch count.

    ``launches`` grows by one for every launch that the library accepted,
    and nowhere else; a run shows that it went through the kernel by
    reading it. ``fn`` is the entry point's ctypes function, bound when
    the library loads, so a launch after the first takes no lock and looks
    nothing up by name.
    """

    def __init__(self, name: str, symbol: str, source: str,
                 replaces: str) -> None:
        self.name = name
        self.symbol = symbol
        self.source = source
        self.replaces = replaces
        self.launches = 0
        self.fn = None

    def launch(self, device: torch.device, *args) -> None:
        if self.fn is None:
            LIBRARY.get()
        # the current stream's raw handle, as PyTorch's own generated
        # kernels fetch it (a torch.cuda.Stream object costs more)
        err = self.fn(*args, device.index,
                      torch._C._cuda_getCurrentRawStream(device.index))
        if err != 0:
            msg = LIBRARY.get().lzs_error_string(err).decode()
            raise KernelError(f"{self.symbol} launch failed: {msg} ({err})")
        self.launches += 1


CUMMAX = Kernel("rowscan_cummax", "lzs_cummax_rows",
                "lzs_tpu_torch/csrc/rowscan.cu",
                "lzs_tpu/ops/pext.py:185")
RCUMMIN = Kernel("rowscan_rcummin", "lzs_rcummin_rows",
                 "lzs_tpu_torch/csrc/rowscan.cu",
                 "lzs_tpu/ops/pext.py:175")
CUMSUM = Kernel("rowscan_cumsum", "lzs_cumsum_rows",
                "lzs_tpu_torch/csrc/rowscan.cu",
                "lzs_tpu/ops/pext.py:194")
RANK_MASK = Kernel("rank_mask", "lzs_rank_mask_rows",
                   "lzs_tpu_torch/csrc/rowscan.cu",
                   "lzs_tpu/ops/pext.py:108")
GATHER_BIG = Kernel("gather_big", "lzs_gather_rows",
                    "lzs_tpu_torch/csrc/gather.cu",
                    "lzs_tpu/ops/pgather.py:29")
PERK_LEVEL = Kernel("perk_level", "lzs_perk_level",
                    "lzs_tpu_torch/csrc/cand.cu",
                    "lzs_tpu/ops/pcand.py:49,58,69")
EXT_BREAKS = Kernel("ext_breaks", "lzs_ext_breaks",
                    "lzs_tpu_torch/csrc/extend.cu", "lzs_tpu/ops/pext.py:65")
EXT_FOLD = Kernel("ext_fold", "lzs_ext_fold", "lzs_tpu_torch/csrc/extend.cu",
                  "lzs_tpu/ops/pext.py:93")
WALK_TABLES = Kernel("walk_tables", "lzs_walk_tables",
                     "lzs_tpu_torch/csrc/walk.cu",
                     "lzs_tpu/ops/pwalk.py:71")
WALK_ENTRIES = Kernel("walk_entries", "lzs_walk_entries",
                      "lzs_tpu_torch/csrc/walk.cu",
                      "lzs_tpu/ops/pwalk.py:90")
WALK_DESCENT = Kernel("walk_descent", "lzs_walk_descent",
                      "lzs_tpu_torch/csrc/walk.cu",
                      "lzs_tpu/ops/pwalk.py:110")
PACK = Kernel("pack", "lzs_pack_rows", "lzs_tpu_torch/csrc/pack.cu",
              "lzs_tpu/ops/ppack.py:34")
SYNC = Kernel("sync", "lzs_sync_rows", "lzs_tpu_torch/csrc/sync.cu",
              "lzs_tpu/ops/psync.py:57")
EXPAND = Kernel("expand", "lzs_expand_rows", "lzs_tpu_torch/csrc/expand.cu",
                "lzs_tpu/ops/pexpand.py:80")
# replaces a lax.scan (the JAX package runs the lane parse as one XLA loop
# on the device), not a pallas_call
PARSE = Kernel("parse", "lzs_parse_lanes", "lzs_tpu_torch/csrc/parse.cu",
               "lzs_tpu/ops/decode2.py:132")
# replaces a lax.scan too: the raw decoder's bit-serial parse (engine
# "scan"), and in its filled form the record fill after it
SCAN_PARSE = Kernel("scan_parse", "lzs_scan_parse",
                    "lzs_tpu_torch/csrc/scan_parse.cu",
                    "lzs_tpu/ops/decode.py:43")
# replaces no pallas_call either: JAX computes the raw decoder's per-bit
# head fields as jnp inside decode_batch_bits, which XLA fuses
RAW_HEADS = Kernel("raw_heads", "lzs_raw_heads", "lzs_tpu_torch/csrc/heads.cu",
                   "lzs_tpu/ops/bitpar.py:155")
# replace no pallas_call either: JAX builds the match search's gram words
# and rank LCPs as jnp around its lax.sort
GRAM_KEYS = Kernel("gram_keys", "lzs_gram_keys", "lzs_tpu_torch/csrc/gram.cu",
                   "lzs_tpu/ops/sortmatch.py:74")
RANK_LCP = Kernel("rank_lcp", "lzs_rank_lcp", "lzs_tpu_torch/csrc/gram.cu",
                  "lzs_tpu/ops/sortmatch.py:197")
# replaces JAX's tier-1 span fetch (a K10 gather) and its jnp compare
PROBE_SPAN = Kernel("probe_span", "lzs_probe_span",
                    "lzs_tpu_torch/csrc/probe.cu",
                    "lzs_tpu/ops/sortmatch.py:445")
KERNELS = (GRAM_KEYS, RANK_LCP, PERK_LEVEL, EXT_BREAKS, EXT_FOLD, RANK_MASK,
           PROBE_SPAN, GATHER_BIG, CUMMAX, RCUMMIN, CUMSUM, WALK_TABLES,
           WALK_ENTRIES, WALK_DESCENT, PACK, SYNC, EXPAND, PARSE, SCAN_PARSE,
           RAW_HEADS)


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict[str, int]:
    return {k.name: k.launches for k in KERNELS}


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """The number of SMs of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


_STREAM_WORDS: dict[tuple[int, int], torch.Tensor] = {}


def stream_words(device: torch.device, count: int) -> torch.Tensor:
    """At least ``count`` int64 words that a kernel keeps from one launch
    to the next (the chained row scans' epoch and status words): zeroed when
    made, one buffer per device and stream, grown (made anew) as needed.
    Launches on one stream run one after another, so they share it. (A
    CUDA graph that captures such a launch keeps its capture stream's
    buffer: replay it on that stream.)"""
    key = (device.index, torch._C._cuda_getCurrentRawStream(device.index))
    words = _STREAM_WORDS.get(key)
    if words is None or words.numel() < count:
        have = 0 if words is None else words.numel()
        words = torch.zeros(max(count, 2 * have, 1024), dtype=torch.int64,
                            device=device)
        _STREAM_WORDS[key] = words
    return words


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU (use the plain version);
    False when every one lies on one CUDA device (launch the kernel).
    Anything else raises: a kernel never falls back."""
    dev = tensors[0].device
    if any(t.device != dev for t in tensors[1:]):
        raise ValueError("tensors on several devices: " + str(sorted(
            {str(t.device) for t in tensors})))
    if dev.type == "cpu":
        return True
    if dev.type == "cuda":
        return False
    raise ValueError(f"no kernel for device {dev}")


def check(t: torch.Tensor, name: str, dtype: torch.dtype,
          shape: tuple[int, ...] | None = None) -> None:
    """Validate a kernel operand: CUDA, dtype, contiguity, shape."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")


def launch_rows(kernel: Kernel, operands: dict[str, torch.Tensor],
                *scalars: int, dtype: torch.dtype = torch.int32
                ) -> torch.Tensor:
    """Launch a kernel over (B, N) rows and return its int32 (B, N) output.

    The first operand sets (B, N) and has ``dtype``; an operand named
    ``n`` (block lengths) is int32 (B,), every other one int32 (B, N).
    Each is checked, a fresh output is allocated, and the kernel runs as
    ``kernel(*operands, out, B, N, *scalars)`` unless the rows are empty.
    """
    names = list(operands)
    first = operands[names[0]]
    check(first, names[0], dtype)
    if first.dim() != 2:
        raise ValueError(f"{names[0]}: expected (B, N), got "
                         f"{tuple(first.shape)}")
    b, npos = first.shape
    for name in names[1:]:
        check(operands[name], name, torch.int32,
              (b,) if name == "n" else (b, npos))
    out = torch.empty((b, npos), dtype=torch.int32, device=first.device)
    if b and npos:
        kernel.launch(first.device, *(t.data_ptr() for t in operands.values()),
                      out.data_ptr(), b, npos, *scalars)
    return out
