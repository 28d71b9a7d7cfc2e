"""ctypes binding to the native C++ runtime (native/lzs_native.cpp).

The port's own copy of ``lzs_tpu.utils.native``. It builds the shared
library on first use with ``make -C native BUILD=build/native`` (under
the repository's ignored ``build/``; the JAX package builds its own copy
into ``native/build``, so the two never share a build). The runtime
provides the C encoder's bytes one-shot and as a streaming session, the
streaming decoder, and the host emission of a stream from match tables.
A failed build or load raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

from .. import spec

_ROOT = pathlib.Path(__file__).resolve().parent.parent.parent
_SRC = _ROOT / "native"
_BUILD = _ROOT / "build" / "native"
_SO = _BUILD / "liblzs_native.so"
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

# status bits (mirrors the enum in lzs_native.cpp and the reference's
# streaming status protocol, lzs.h:90-99/170-178)
INPUT_STARVED = 1
OUTPUT_FULL = 2
FINISHED = 4
END_MARKER = 8


def _build() -> None:
    # build in a directory of this process's own, then rename the library
    # into place, so that processes building at once never load a
    # half-written file
    tmp = _BUILD / f"tmp-{os.getpid()}"
    try:
        res = subprocess.run(["make", "-s", "-C", str(_SRC), f"BUILD={tmp}"],
                             capture_output=True, text=True)
        if res.returncode:
            raise RuntimeError(f"building {_SO} failed:\n{res.stderr}")
        os.replace(tmp / _SO.name, _SO)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def load() -> ctypes.CDLL:
    """Load (building if needed) the native library."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        src = _SRC / "lzs_native.cpp"
        if (not _SO.exists()
                or _SO.stat().st_mtime < src.stat().st_mtime):
            _build()
        lib = ctypes.CDLL(str(_SO))
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i32p = ctypes.POINTER(ctypes.c_int32)
        szp = ctypes.POINTER(ctypes.c_size_t)
        lib.lzs_nat_compress.restype = ctypes.c_size_t
        lib.lzs_nat_compress.argtypes = [u8p, ctypes.c_size_t, u8p,
                                         ctypes.c_size_t]
        lib.lzs_nat_emit.restype = ctypes.c_size_t
        lib.lzs_nat_emit.argtypes = [u8p, ctypes.c_size_t, i32p, i32p,
                                     u8p, ctypes.c_size_t]
        lib.lzs_nat_decompress.restype = ctypes.c_size_t
        lib.lzs_nat_decompress.argtypes = [u8p, ctypes.c_size_t, u8p,
                                           ctypes.c_size_t, ctypes.c_int,
                                           szp]
        lib.lzs_nat_enc_new.restype = ctypes.c_void_p
        lib.lzs_nat_enc_free.argtypes = [ctypes.c_void_p]
        lib.lzs_nat_enc_feed.restype = ctypes.c_int
        lib.lzs_nat_enc_feed.argtypes = [ctypes.c_void_p, u8p,
                                         ctypes.c_size_t, u8p,
                                         ctypes.c_size_t, ctypes.c_int,
                                         szp, szp]
        lib.lzs_nat_dec_new.restype = ctypes.c_void_p
        lib.lzs_nat_dec_free.argtypes = [ctypes.c_void_p]
        lib.lzs_nat_dec_markers.restype = ctypes.c_int
        lib.lzs_nat_dec_markers.argtypes = [ctypes.c_void_p]
        lib.lzs_nat_dec_feed.restype = ctypes.c_int
        lib.lzs_nat_dec_feed.argtypes = [ctypes.c_void_p, u8p,
                                         ctypes.c_size_t, u8p,
                                         ctypes.c_size_t, szp, szp]
        _lib = lib
        return lib


def _u8(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def compress(data: bytes) -> bytes:
    """One-shot native compress (reference-identical stream)."""
    lib = load()
    x = np.frombuffer(data, np.uint8)
    cap = spec.compressed_max(len(data)) + 16
    out = np.zeros(cap, np.uint8)
    m = lib.lzs_nat_compress(_u8(x), len(data), _u8(out), cap)
    if m == ctypes.c_size_t(-1).value:
        raise RuntimeError("native compress: output overflow")
    return out[:m].tobytes()


def emit(data: bytes, score: np.ndarray, off: np.ndarray) -> bytes:
    """Hybrid assembly: pack a stream from device match tables."""
    lib = load()
    x = np.frombuffer(data, np.uint8)
    score = np.ascontiguousarray(score, np.int32)
    off = np.ascontiguousarray(off, np.int32)
    cap = spec.compressed_max(len(data)) + 16
    out = np.zeros(cap, np.uint8)
    m = lib.lzs_nat_emit(
        _u8(x), len(data),
        score.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        off.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        _u8(out), cap)
    if m == ctypes.c_size_t(-1).value:
        raise RuntimeError("native emit: output overflow")
    return out[:m].tobytes()


def decompress(data: bytes, out_cap: Optional[int] = None,
               multi_stream: bool = False) -> bytes:
    """One-shot native decompress."""
    lib = load()
    x = np.frombuffer(data, np.uint8)
    cap = (out_cap if out_cap is not None
           else max(spec.decompressed_max(len(data)), 1 << 16))
    out = np.zeros(cap, np.uint8)
    consumed = ctypes.c_size_t(0)
    m = lib.lzs_nat_decompress(_u8(x), len(data), _u8(out), cap,
                               int(multi_stream),
                               ctypes.byref(consumed))
    return out[:m].tobytes()


class StreamEncoder:
    """Streaming native encoder session (carried window state)."""

    def __init__(self) -> None:
        self._lib = load()
        self._h = self._lib.lzs_nat_enc_new()

    def feed(self, data: bytes, finish: bool = False,
             out_cap: Optional[int] = None) -> Tuple[bytes, int]:
        cap = out_cap if out_cap is not None else (
            spec.compressed_max(len(data)) + (1 << 16))
        out = np.empty(cap, np.uint8)   # fully overwritten up to out_used
        x = np.frombuffer(data, np.uint8) if data else np.zeros(1, np.uint8)
        iu, ou = ctypes.c_size_t(0), ctypes.c_size_t(0)
        st = self._lib.lzs_nat_enc_feed(self._h, _u8(x), len(data),
                                        _u8(out), cap, int(finish),
                                        ctypes.byref(iu), ctypes.byref(ou))
        return out[:ou.value].tobytes(), st

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.lzs_nat_enc_free(self._h)
            self._h = None

    def __del__(self) -> None:  # pragma: no cover
        self.close()


class StreamDecoder:
    """Streaming native decoder session (crosses end markers)."""

    def __init__(self) -> None:
        self._lib = load()
        self._h = self._lib.lzs_nat_dec_new()

    def feed(self, data: bytes, out_cap: int = 1 << 20) -> Tuple[bytes, int]:
        out = np.empty(out_cap, np.uint8)  # fully overwritten up to out_used
        x = np.frombuffer(data, np.uint8) if data else np.zeros(1, np.uint8)
        iu, ou = ctypes.c_size_t(0), ctypes.c_size_t(0)
        st = self._lib.lzs_nat_dec_feed(self._h, _u8(x), len(data),
                                        _u8(out), out_cap,
                                        ctypes.byref(iu), ctypes.byref(ou))
        return out[:ou.value].tobytes(), st

    @property
    def markers(self) -> int:
        return self._lib.lzs_nat_dec_markers(self._h)

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.lzs_nat_dec_free(self._h)
            self._h = None

    def __del__(self) -> None:  # pragma: no cover
        self.close()
