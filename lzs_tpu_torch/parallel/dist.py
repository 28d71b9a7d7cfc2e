"""Block data parallelism over ranks on torch.distributed.

Port of ``lzs_tpu.parallel.dist``. Design:

  * independent blocks are split over a 1-D device mesh ("blocks"), one
    rank per device: NCCL with one CUDA device a rank (``cuda:<LOCAL_RANK>``),
    or gloo on the CPU
  * each rank runs the full encode/decode pipeline on its contiguous shard
    of the batch, on its own device
  * per-block compressed lengths, sync records and padded payloads are
    exchanged with an all-gather in rank order, so every rank holds the
    whole batch in the input's block order (JAX's tiled ``all_gather``)

The host API assembles with slabs: the payload through
``blocks.concat_streams``, the compressed rows by one masked fill and
the output trimmed by one mask, one copy to the host per array. Every
rank runs the same calls on the same input (one program, many ranks),
as JAX's callables do on every host.

Launch ranks with ``torchrun --nproc_per_node=N script.py`` (the
``env://`` variables), or call ``initialize_distributed`` with an
``init_method`` such as ``file:///path`` or ``tcp://localhost:port``, a
world size and a rank.
"""

from __future__ import annotations

import dataclasses
import datetime
import os

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from .. import trace
from ..blocks import concat_streams, pad_blocks
from ..ops import decode2 as dec2_ops
from ..ops import encode as enc_ops

AXIS = "blocks"


def initialize_distributed(init_method: str | None = None,
                           world_size: int | None = None,
                           rank: int | None = None, *,
                           device_type: str = "cuda",
                           timeout: datetime.timedelta | None = None) -> None:
    """Start this process's rank of the default process group.

    Arguments default to torch's ``env://`` variables (MASTER_ADDR,
    MASTER_PORT, WORLD_SIZE, RANK, as ``torchrun`` sets them). The
    backend is NCCL for ranks on CUDA devices (``device_type``, the card
    unless the caller names "cpu") and gloo on the CPU. Idempotent: a
    started group is left as it is.
    """
    if dist.is_initialized():
        return
    kwargs = {"init_method": init_method or "env://"}
    if world_size is not None:
        kwargs["world_size"] = world_size
    if rank is not None:
        kwargs["rank"] = rank
    if timeout is not None:
        kwargs["timeout"] = timeout
    dist.init_process_group(
        backend="nccl" if device_type == "cuda" else "gloo", **kwargs)


def make_block_mesh(device_type: str = "cuda") -> DeviceMesh:
    """1-D mesh named "blocks" over every rank of the default group (which
    ``initialize_distributed`` starts, or this call from ``env://``). On
    CUDA each rank runs on ``cuda:<LOCAL_RANK>``."""
    if device_type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    world = dist.get_world_size() if dist.is_initialized() else int(
        os.environ["WORLD_SIZE"])
    return init_device_mesh(device_type, (world,), mesh_dim_names=(AXIS,))


def _rank_device(mesh: DeviceMesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _shard(a, rank: int, world: int, device: torch.device) -> torch.Tensor:
    """This rank's contiguous shard of a host batch, on ``device``."""
    t = torch.as_tensor(a)
    if t.shape[0] % world:
        raise ValueError(f"batch {t.shape[0]} is not a multiple of the "
                         f"mesh size {world}")
    per = t.shape[0] // world
    return t[rank * per:(rank + 1) * per].contiguous().to(device)


def _all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``t`` concatenated on the batch axis in rank order."""
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts)


def encode_sharded(mesh: DeviceMesh, *, span: int = enc_ops.SYNC_SPAN):
    """A sharded batch encoder with an ordered all-gather.

    Returns fn: (uint8[B, block], int32[B]) -> (comp, clens, sync_bit,
    sync_out, nsync), whole batches (``encode.encode_batch_sync``'s
    arrays) on this rank's device, the same on every rank. B must be a
    multiple of the mesh size. JAX's ``block`` and ``chunk`` arguments
    have no counterpart: the port's encoder reads the block width from
    its input and takes no chunk (``encode.make_encoder`` dropped both
    too), and ``span`` is keyword-only, so a call in JAX's positional
    form raises.
    """
    group = mesh.get_group(AXIS)
    world, rank = mesh.size(), mesh.get_local_rank(AXIS)
    device = _rank_device(mesh)

    def call(x, n):
        with trace.host("copy_in"):
            xs = _shard(x, rank, world, device)
            ns = _shard(n, rank, world, device)
        outs = enc_ops.encode_batch_sync(xs, ns, span=span)
        with trace.host("gather"):
            return tuple(_all_gather(o, group) for o in outs)

    return call


def decode_sharded(mesh: DeviceMesh, block: int,
                   span: int = enc_ops.SYNC_SPAN):
    """A sharded sync-parallel batch decoder (same layout): (comp
    uint8[B, C], sync_bit, sync_out int32[B, I], n int32[B]) ->
    uint8[B, block] on this rank's device, the same on every rank."""
    group = mesh.get_group(AXIS)
    world, rank = mesh.size(), mesh.get_local_rank(AXIS)
    device = _rank_device(mesh)

    def call(comp, sbit, sout, n):
        out, _ = dec2_ops.decode_batch_sync(
            *(_shard(a, rank, world, device) for a in (comp, sbit, sout, n)),
            out_cap=block, span=span)
        return _all_gather(out, group)

    return call


@dataclasses.dataclass
class DistributedCodec:
    """Host API: compress/decompress with blocks sharded over a mesh.

    The batch dimension is padded to a multiple of the mesh size with
    empty blocks, so every rank holds an equal shard (an empty block
    encodes to a bare end marker and is dropped on assembly). JAX's
    ``chunk`` has no counterpart: the port's encoder does not read one.
    """
    mesh: DeviceMesh
    block: int = 1 << 15
    span: int = enc_ops.SYNC_SPAN

    def __post_init__(self):
        self.cap = enc_ops.cap_bytes(self.block)
        self.slots = enc_ops.sync_slots(self.block, self.span)
        self._enc = encode_sharded(self.mesh, span=self.span)
        self._dec = decode_sharded(self.mesh, self.block, self.span)

    @property
    def ndev(self) -> int:
        return self.mesh.size()

    def _pad_batch(self, arr: np.ndarray) -> np.ndarray:
        b = arr.shape[0]
        want = -(-b // self.ndev) * self.ndev
        pad = np.zeros((want - b,) + arr.shape[1:], arr.dtype)
        return np.concatenate([arr, pad], axis=0)

    def compress(self, data: bytes):
        """Returns (payload, clens, sync_bit, sync_out, nsync) with
        payload = raw concatenated streams in original block order."""
        with trace.host("pad"):
            x, lens = pad_blocks(data, self.block)
            nblocks = x.shape[0]
            x, lens = self._pad_batch(x), self._pad_batch(lens)
        comp, clens, sbit, sout, nsync = self._enc(x, lens)
        with trace.host("wait"):  # the boolean mask reads its count
            flat, total = concat_streams(comp[:nblocks], clens[:nblocks])
            nbytes = int(total)
        with trace.host("copy_out"):
            return (flat[:nbytes].cpu().numpy().tobytes(),
                    clens[:nblocks].cpu().tolist(),
                    sbit[:nblocks].cpu().numpy(),
                    sout[:nblocks].cpu().numpy(),
                    nsync[:nblocks].cpu().numpy())

    def decompress(self, payload: bytes, clens, sbit, sout,
                   out_lens) -> bytes:
        clens = np.asarray(clens, np.int64)
        nblocks = len(clens)
        comp = np.zeros((nblocks, self.cap), np.uint8)
        comp[np.arange(self.cap)[None, :] < clens[:, None]] = np.frombuffer(
            payload, np.uint8, int(clens.sum()))
        lens = np.asarray(out_lens, np.int32)
        out = self._dec(self._pad_batch(comp),
                        self._pad_batch(np.asarray(sbit, np.int32)),
                        self._pad_batch(np.asarray(sout, np.int32)),
                        self._pad_batch(lens))[:nblocks]
        keep = (torch.arange(self.block, device=out.device)[None, :]
                < torch.from_numpy(lens).to(out.device)[:, None])
        return out[keep].cpu().numpy().tobytes()
