"""File-to-file compression CLIs (port of ``lzs_tpu.cli``).

Matches the reference CLI contract (c/src/utils/lzs-compress.c:60-76,
python/lzs-compress.py:44-49): ``lzs-compress INFILE OUTFILE`` /
``lzs-decompress INFILE OUTFILE`` produce/consume raw LZS streams that
interoperate with the reference implementations.

The default compress path is the batch pipeline on ``--device`` (the
CUDA card unless the caller names another), emitting raw concatenated
per-block streams: each block an independent LZS stream with its own end
marker, which the reference incremental decoder (the reference CLI
default, lzs-decompression.c:559-576) decodes as one stream. ``--stream``
selects the carried-window streaming codec instead (one continuous
stream, byte-identical to the reference incremental encoder; its match
search on ``--device``). ``--container`` adds the framing that enables
the sync-parallel decoder.

A raw stream of any length decodes on ``--device`` (engine "bits",
multi-stream) in windows of the input, each window's output appended on
the host (``ops.bitpar.decode_to_host``): no output capacity, so no
retry. Where the JAX package's CLI sends a stream to its host decoder
(an output past 2^18 bytes or 16 times the input), this one has no host
route. ``-v`` prints the route taken. Any failure on the device raises;
nothing falls back.

Usage:
    python -m lzs_tpu_torch.cli compress   [--container | --stream] IN OUT
    python -m lzs_tpu_torch.cli decompress [--container] IN OUT
"""

from __future__ import annotations

import argparse
import pathlib
import struct
import sys

import numpy as np
import torch


def _compress(args) -> int:
    from .blocks import BlockCodec
    from .stream import compress_stream

    data = pathlib.Path(args.infile).read_bytes()
    policy = "lazy" if args.lazy else "greedy"
    if args.container:
        out = BlockCodec(block=args.block, policy=policy,
                         device=args.device).compress(data)
    elif args.stream:
        if args.lazy:
            raise SystemExit("--lazy needs the device batch path "
                             "(--blocks or --container)")
        out = compress_stream(data, feed_size=args.block, device=args.device)
    else:
        out = BlockCodec(block=args.block, policy=policy,
                         device=args.device).compress(data, container=False)
    pathlib.Path(args.outfile).write_bytes(out)
    if args.verbose:
        ratio = len(out) / max(len(data), 1)
        print(f"{len(data)} -> {len(out)} bytes ({ratio:.1%})",
              file=sys.stderr)
    return 0


def _decompress_raw_device(data: bytes, device) -> bytes:
    """Decode a raw (reference-format) stream chain on ``device``.

    The per-bit parallel decoder (``ops.bitpar``, engine "bits") with
    multi-stream semantics, over windows of the input with no output
    capacity: each window's output length is its records' total, read
    once, and its bytes are expanded on the device and appended on the
    host. Errors raise.
    """
    from .ops import bitpar

    if not data:
        return b""
    comp = torch.from_numpy(np.frombuffer(data, np.uint8).copy()).to(device)
    return bitpar.decode_to_host(comp, multi_stream=True)


def _decompress(args) -> int:
    data = pathlib.Path(args.infile).read_bytes()
    if args.container or data[:4] == b"LZST":
        from .blocks import BlockCodec
        block = struct.unpack_from("<I", data, 8)[0]
        span = struct.unpack_from("<H", data, 6)[0]
        out = BlockCodec(block=block, span=span,
                         device=args.device).decompress(data)
        route = "device, container"
    else:
        out = _decompress_raw_device(data, args.device)
        route = "device"
    pathlib.Path(args.outfile).write_bytes(out)
    if args.verbose:
        print(f"{len(data)} -> {len(out)} bytes", file=sys.stderr)
        print(f"route: {route}", file=sys.stderr)
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="lzs_tpu_torch.cli", description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)
    for name, fn in (("compress", _compress), ("decompress", _decompress)):
        p = sub.add_parser(name)
        p.add_argument("infile")
        p.add_argument("outfile")
        p.add_argument("--container", action="store_true",
                       help="block-parallel container framing")
        p.add_argument("--block", type=int, default=1 << 15,
                       help="block / feed size")
        p.add_argument("--device", default="cuda",
                       help="torch device of the device work (default "
                            "cuda; cpu runs the kernels' plain versions)")
        p.add_argument("-v", "--verbose", action="store_true")
        p.set_defaults(fn=fn)
        if name == "compress":
            p.add_argument("--stream", action="store_true",
                           help="carried-window streaming codec (one "
                                "continuous stream, byte-identical to the "
                                "reference incremental encoder)")
            p.add_argument("--blocks", action="store_true",
                           help="(default) raw concatenated per-block "
                                "streams via the batch pipeline")
            p.add_argument("--lazy", action="store_true",
                           help="1-token-lookahead match selection "
                                "(usually smaller output; still a valid "
                                "LZS stream, decodable by the reference "
                                "decoder)")
        else:
            p.set_defaults(blocks=False, stream=False)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


def main_compress(argv=None) -> int:
    """``lzs-compress INFILE OUTFILE`` — the reference's two-argument CLI
    contract (c/src/utils/lzs-compress.c:60-76)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    return main(["compress"] + argv)


def main_decompress(argv=None) -> int:
    """``lzs-decompress INFILE OUTFILE`` (c/src/utils/lzs-decompress.c)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    return main(["decompress"] + argv)


if __name__ == "__main__":
    raise SystemExit(main())
