"""Multi-block batch codec and container framing, on one torch device.

Port of ``lzs_tpu.blocks``. Independent fixed-size blocks are the unit
of data parallelism: each block is a self-terminating LZS stream with
its own end marker, so the raw concatenation of block streams is itself
a valid stream chain that the reference incremental decoder reads
(lzs-decompression.c:559-576).

Two output formats, byte-identical to the JAX package's:

  raw        pure concatenated LZS streams (reference-CLI compatible).
  container  (version 4) a header carrying block size, per-block
             compressed lengths, an adler32 payload checksum and the parse
             sync records, then the raw payload. Decoding validates the
             checksum, the per-lane parse boundaries and the per-block
             expansion status words, raising ValueError on corruption.
"""

from __future__ import annotations

import dataclasses
import struct
import zlib

import numpy as np
import torch

from . import trace
from .ops import decode as dec_ops
from .ops import decode2 as dec2_ops
from .ops import encode as enc_ops

MAGIC = b"LZST"
VERSION = 4
DEFAULT_BLOCK = 1 << 15
_HDR = "<4sBBHIIQI"

FLAG_LAZY = 1          # container flags bit: lazy (1-token-lookahead) policy
_KNOWN_FLAGS = FLAG_LAZY


def pad_blocks(data: bytes, block: int) -> tuple[np.ndarray, np.ndarray]:
    """Split data into a (B, block) uint8 array plus per-block lengths."""
    n = len(data)
    nblocks = max(1, -(-n // block))
    x = np.zeros(nblocks * block, np.uint8)
    x[:n] = np.frombuffer(data, np.uint8)
    lens = np.clip(n - block * np.arange(nblocks), 0, block).astype(np.int32)
    return x.reshape(nblocks, block), lens


def concat_streams(comp: torch.Tensor, lens: torch.Tensor) -> tuple[
        torch.Tensor, torch.Tensor]:
    """Ragged concatenation of per-block streams on the device.

    comp: uint8[B, C]; lens: int32[B]. Returns (flat uint8[B*C], total):
    the first ``total`` bytes of ``flat`` are the streams in block order.
    """
    nb, cap = comp.shape
    j = torch.arange(cap, device=comp.device)[None, :]
    keep = comp[j < lens[:, None]]
    flat = torch.zeros(nb * cap, dtype=torch.uint8, device=comp.device)
    flat[:keep.numel()] = keep
    return flat, lens.sum()


@dataclasses.dataclass
class BlockCodec:
    """Batch codec over fixed-size blocks on one torch ``device``.

    ``device`` is the CUDA card unless the caller names another ("cpu"
    runs every kernel's plain torch version); without a card the default
    codec raises at its first use. ``policy``: "greedy" (reference byte
    parity) or "lazy" (1-token lookahead: usually smaller output, still a
    valid LZS stream; the container flags byte records which policy
    produced a blob).

    ``block`` is the only positional field. The JAX package's codec takes
    (block, chunk, span, policy) and the port has no ``chunk``, so the
    rest are keyword-only: a JAX-style ``BlockCodec(block, 4096)`` raises
    TypeError instead of building a codec with another span.
    """
    block: int = DEFAULT_BLOCK
    _: dataclasses.KW_ONLY
    span: int = enc_ops.SYNC_SPAN
    policy: str = "greedy"
    device: torch.device | str = "cuda"

    def __post_init__(self):
        if self.policy not in ("greedy", "lazy"):
            raise ValueError(f"unknown policy {self.policy!r}")
        self.device = torch.device(self.device)
        self.cap = enc_ops.cap_bytes(self.block)
        self.slots = enc_ops.sync_slots(self.block, self.span)

    # -- device-level primitives (fixed batch shape) --
    def encode_batch(self, x: torch.Tensor, n: torch.Tensor):
        """(uint8[B, block], int32[B]) -> (comp uint8[B, cap], clen
        int32[B], sync_bit int32[B, I], sync_out int32[B, I], nsync
        int32[B])."""
        return enc_ops.encode_batch_sync(x, n, span=self.span,
                                         policy=self.policy)

    def decode_batch(self, comp, sync_bit, sync_out, n):
        """Sync-parallel batch decode -> uint8[B, block]."""
        return self.decode_batch_status(comp, sync_bit, sync_out, n)[0]

    def decode_batch_status(self, comp, sync_bit, sync_out, n):
        """Sync-parallel batch decode with per-block status words
        (decode2.decode_batch_sync lists the bits)."""
        return dec2_ops.decode_batch_sync(comp, sync_bit, sync_out, n,
                                          out_cap=self.block, span=self.span)

    def decode_batch_raw(self, comp: torch.Tensor, nbytes: torch.Tensor):
        """Metadata-free batch decode of raw streams (reference semantics,
        the per-bit parallel parse): (uint8[B, C], int32[B]) -> (out
        uint8[B, block], out_len int32[B], end_markers int32[B])."""
        return dec_ops.decode_batch(comp, nbytes, out_cap=self.block)

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # -- host-level byte APIs --
    def compress(self, data: bytes, container: bool = True) -> bytes:
        with trace.host("pad"):
            x, lens = pad_blocks(data, self.block)
        with trace.host("copy_in"):
            xt, nt = self._to_device(x), self._to_device(lens)
        comp, clens, sbit, sout, nsync = self.encode_batch(xt, nt)
        with trace.host("wait"):  # the boolean mask reads its count
            flat, total = concat_streams(comp, clens)
            nbytes = int(total)
        with trace.host("copy_out"):
            payload = flat[:nbytes].cpu().numpy().tobytes()
            if not container:
                return payload
            clens_np = clens.cpu().numpy().astype(np.uint32)
            nsync_np = nsync.cpu().numpy().astype(np.uint32)
            sbit_np = sbit.cpu().numpy()
            sout_np = sout.cpu().numpy()
        with trace.host("container"):
            # the per-block end sentinel (bit offset of the end marker) is
            # the value the encoder stores in unused slots
            endbits = sbit_np[:, -1].astype(np.uint32)
            live = (np.arange(sbit_np.shape[1])[None, :]
                    < nsync_np[:, None].astype(np.int64))
            recs_np = np.stack([sbit_np[live], sout_np[live]],
                               axis=1).astype(np.uint32)
            crc = zlib.adler32(payload) & 0xFFFFFFFF
            flags = FLAG_LAZY if self.policy == "lazy" else 0
            header = struct.pack(_HDR, MAGIC, VERSION, flags, self.span,
                                 self.block, len(clens_np), len(data), crc)
            return (header + clens_np.tobytes() + nsync_np.tobytes()
                    + endbits.tobytes() + recs_np.tobytes() + payload)

    def decompress(self, blob: bytes) -> bytes:
        """Decode a container blob.

        Every header field is validated against the payload before use:
        malformed, truncated or hostile containers raise ValueError,
        never index errors or silent corruption.
        """
        hdr_size = struct.calcsize(_HDR)
        if len(blob) < hdr_size:
            raise ValueError("container truncated: header incomplete")
        if blob[:4] != MAGIC:
            raise ValueError("not a container stream; use raw decode")
        magic, ver, flags, span, block, nblocks, orig, crc = \
            struct.unpack_from(_HDR, blob)
        if ver != VERSION:
            raise ValueError(f"unsupported container version {ver}")
        if flags & ~_KNOWN_FLAGS:
            raise ValueError(f"unknown container flags {flags:#x}")
        if block != self.block or span != self.span:
            raise ValueError("container block/span mismatch with codec")
        if nblocks < 1 or nblocks > len(blob):
            raise ValueError(f"implausible block count {nblocks}")
        if not orig <= nblocks * block:
            raise ValueError(
                f"decoded size {orig} exceeds {nblocks} x {block} blocks")
        if orig and not orig > (nblocks - 1) * block:
            raise ValueError("decoded size implies empty trailing blocks")

        def _take(count: int, pos: int, what: str) -> np.ndarray:
            if pos + 4 * count > len(blob):
                raise ValueError(f"container truncated in {what}")
            return np.frombuffer(blob, np.uint32, count, pos).astype(
                np.int64)

        pos = hdr_size
        clens = _take(nblocks, pos, "block lengths")
        pos += 4 * nblocks
        nsync = _take(nblocks, pos, "sync counts")
        pos += 4 * nblocks
        endbits = _take(nblocks, pos, "end offsets").astype(np.int32)
        pos += 4 * nblocks
        if (clens > self.cap).any() or (clens < 0).any():
            raise ValueError("block compressed length exceeds capacity")
        if (nsync > self.slots).any():
            raise ValueError("sync record count exceeds slot capacity")
        total_recs = int(nsync.sum())
        recs64 = _take(2 * total_recs, pos, "sync records")
        recs = recs64.reshape(total_recs, 2).astype(np.int32)
        pos += 8 * total_recs
        payload = np.frombuffer(blob, np.uint8, offset=pos)
        if len(payload) < clens.sum():
            raise ValueError("container truncated in payload")
        if zlib.adler32(payload.tobytes()) & 0xFFFFFFFF != crc:
            raise ValueError("payload checksum mismatch")
        clens = clens.astype(np.int32)
        nsync = nsync.astype(np.int32)
        if (recs < 0).any() or (
                recs[:, 0] > int(clens.max(initial=0)) * 8).any():
            raise ValueError("sync record bit offset out of payload range")

        lens = np.full(nblocks, block, np.int32)
        if orig:
            lens[-1] = orig - block * (nblocks - 1)
        else:
            lens[:] = 0
        # slab fills: boolean-mask assignment walks rows in order, which
        # is the payload / record concatenation order
        comp = np.zeros((nblocks, self.cap), np.uint8)
        cmask = np.arange(self.cap)[None, :] < clens[:, None]
        comp[cmask] = payload[:int(clens.sum())]
        smask = np.arange(self.slots)[None, :] < nsync[:, None]
        sbit = np.broadcast_to(endbits[:, None],
                               (nblocks, self.slots)).copy()
        sout = np.broadcast_to(lens[:, None],
                               (nblocks, self.slots)).copy()
        sbit[smask] = recs[:, 0]
        sout[smask] = recs[:, 1]
        out, status = self.decode_batch_status(
            self._to_device(comp), self._to_device(sbit),
            self._to_device(sout), self._to_device(lens))
        status_np = status.cpu().numpy()
        if status_np.any():
            bad = np.nonzero(status_np)[0]
            raise ValueError(
                f"decode integrity failure in block(s) {bad.tolist()} "
                f"(status {[int(status_np[i]) for i in bad]})")
        omask = torch.arange(self.block, device=out.device)[None, :] \
            < self._to_device(lens)[:, None]
        result = out[omask].cpu().numpy().tobytes()
        if len(result) != orig:
            raise ValueError(
                f"decoded size {len(result)} != recorded {orig}")
        return result
