"""lzs_tpu_torch: the LZS codec on PyTorch, with CUDA kernels.

The port of ``lzs_tpu`` (JAX on a TPU) to PyTorch and CUDA on an NVIDIA
Hopper GPU. It imports torch and numpy, never jax. The JAX package is
its reference: every stage here matches its counterpart exactly.

Layout (mirrors ``lzs_tpu``):
  spec.py        wire-format constants
  reference.py   the NumPy model of the codec (host oracle)
  coders.py      generalized pluggable offset/length coders + the
                 GeneralCodec pipeline (its match search on the card)
  stream.py      streaming codec with carried window state: match search
                 on the card, walk and emission on the host
  ops/           the container codec path and the raw-stream decoder:
                   sortmatch.py  sort-based match search + run extension
                   match.py      exhaustive windowed-compare search
                   pcand.py      per-k match-search glue (kernels + plain)
                   tokenize.py   greedy token walk + emission units
                   pwalk.py      token walk (kernels + plain form)
                   bitpack.py    bit pack (ppack.py: kernel + plain form)
                   encode.py     encode pipeline + sync records (psync.py)
                   decode2.py    sync-parallel container decoder
                   bitpar.py     per-bit parallel raw-stream decoder
                   decode.py     raw decode entry points, engines
                                 "bits" and "scan" (the scan parse:
                                 kernel + plain form)
                   pext.py       row scans and the extension scans
                                 (kernels + plain form)
                   pexpand.py    copy expansion (kernel + plain form)
                   _kernels.py   nvcc build, ctypes loader, launch counts
  csrc/          the hand-written CUDA kernels (sm_90a)
  blocks.py      BlockCodec and the container framing
  sessions.py    SessionCodec: one carried history a link (PPP Stac LZS,
                 RFC 1974), one packet a link a call through the encode
                 pipeline
  parallel/      block data parallelism over ranks (torch.distributed)
  models/        named codec profiles
  cli.py         file-to-file compress/decompress
  convert.py     codec settings and batch arrays across the two packages
  trace.py       named stage spans (profiler annotations, stage times)
  utils/         the native C++ runtime's binding (native.py), token
                 dumps, stream stats and profiling hooks (debug.py)

A kernel runs for a tensor on a CUDA device; a tensor on the CPU runs
the kernel's plain torch version. Nothing falls back. The entry points
(``BlockCodec``, ``SessionCodec``, ``ops.decode.decode_bytes``,
``ops.encode.encode_bytes``, ``StreamCompressor``,
``stream.compress_stream``, ``GeneralCodec``, ``models.get_profile``, ``parallel.DistributedCodec``, the CLI,
``convert.codec_from_jax``, ``convert.stream_state_from_jax``,
``convert.general_codec_from_jax``) run on the card unless the caller
asks for ``device="cpu"``.

``SessionCodec`` carries one history a link: two calls on two links,
and link 0's packets read back by a ``StreamDecompressor``, which keeps
its history across the end markers::

    codec = SessionCodec(2, mtu=8, device="cpu")
    x = torch.frombuffer(bytearray(b"abcabcabhello wo"), dtype=torch.uint8)
    a, na = codec.compress(x.reshape(2, 8), torch.tensor([8, 5]))
    b, nb = codec.compress(x.reshape(2, 8), torch.tensor([8, 8]))
    assert StreamDecompressor().feed(bytes(a[0, :na[0]]) + bytes(
        b[0, :nb[0]])) == b"abcabcab" * 2
"""

from .spec import DEFAULT_CONFIG, LzsConfig, compressed_max
from .reference import lzs_compress, lzs_decompress
from .blocks import BlockCodec
from .sessions import SessionCodec

__version__ = "0.1.0"

__all__ = ["BlockCodec", "DEFAULT_CONFIG", "GeneralCodec", "LzsConfig",
           "SessionCodec", "StreamCompressor", "StreamDecompressor",
           "compressed_max", "lzs_compress", "lzs_decompress"]


def __getattr__(name):
    # the streaming classes and the coders load on first use, as in the
    # JAX package
    if name in ("StreamCompressor", "StreamDecompressor"):
        from . import stream
        return getattr(stream, name)
    if name == "GeneralCodec":
        from .coders import GeneralCodec
        return GeneralCodec
    raise AttributeError(name)
