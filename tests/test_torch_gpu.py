"""lzs_tpu_torch on a CUDA device: each kernel against its plain version.

These tests need the card and skip without one. They import no jax (the
GPU machine has none), so run them there without the JAX test fixtures:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Edge shapes the main path does not reach (one element, widths that are
not a multiple of the CTA, 70000-wide rows, hand-made records that set
every status bit) are compared bitwise with the plain versions on the
same CUDA tensors, and the codec's bytes on the card with its bytes on
the CPU.
"""

import numpy as np
import pytest
import torch

from lzs_tpu_torch.blocks import BlockCodec
from lzs_tpu_torch.ops import _kernels, encode, pexpand, pext, ppack, psync

pytestmark = pytest.mark.gpu

END = (0b110000000, 9)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _rows(seed, b, w, dev):
    rng = np.random.default_rng(seed)
    v = rng.integers(-(1 << 20), 1 << 20, (b, w), dtype=np.int64)
    pick = rng.random((b, w))
    v[pick < 0.15] = -1
    v[pick > 0.85] = 0x3FFFFFFF
    return torch.from_numpy(v.astype(np.int32)).to(dev)


def _equal(got, want):
    for g, w in zip(got, want, strict=True):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)


@pytest.mark.parametrize("b,w", [(1, 1), (33, 1000), (5, 1025),
                                 (2, 38656), (3, 70000)])
def test_rowscan_kernels(cuda, b, w):
    v = _rows(b + w, b, w, cuda)
    before = _kernels.CUMMAX.launches, _kernels.RCUMMIN.launches
    _equal([pext.cummax_rows(v), pext.rcummin_rows(v)],
           [pext.cummax_rows_plain(v), pext.rcummin_rows_plain(v)])
    assert (_kernels.CUMMAX.launches, _kernels.RCUMMIN.launches) == (
        before[0] + 1, before[1] + 1)


@pytest.mark.parametrize("end_marker", [None, END])
@pytest.mark.parametrize("b,m", [(1, 1), (3, 1000), (2, 32768)])
def test_pack_kernel(cuda, end_marker, b, m):
    rng = np.random.default_rng(m)
    widths = np.array([0, 0, 4, 9, 11, 13, 17, 25])
    w = widths[rng.integers(0, len(widths), (b, m))].astype(np.int32)
    w[0, : m // 3] = 0
    v = (rng.integers(0, 1 << 25, (b, m)) & ((1 << w) - 1)).astype(np.int32)
    cap = (m * 25 // 8 + 16) & ~3
    vt, wt = torch.from_numpy(v).to(cuda), torch.from_numpy(w).to(cuda)
    _equal(ppack.pack_rows(vt, wt, cap, end_marker),
           ppack.pack_rows_plain(vt, wt, cap, end_marker))


def _units(dev, npos, datas, span):
    x = np.zeros((len(datas), npos), np.uint8)
    n = np.array([len(d) for d in datas], np.int32)
    for i, d in enumerate(datas):
        x[i, :len(d)] = np.frombuffer(d, np.uint8)
    xt = torch.from_numpy(x).to(dev)
    nt = torch.from_numpy(n).to(dev)
    _, _, total, offs, width, starts, off = encode._pipeline_batch(
        xt, nt, 2047, 12)
    nslots = encode.sync_slots(npos, span)
    return (starts.to(torch.int32), width, off, offs, total - 9, nt), dict(
        span=span, nibbles=6, short_len=8, ext_len=15, nslots=nslots)


@pytest.mark.parametrize("span", [96, 288, 2048])
def test_sync_kernel(cuda, span):
    rng = np.random.default_rng(span)
    datas = [bytes(range(64)), b"Z" * 500 + b"the quick brown fox " * 25,
             rng.integers(0, 256, 1024, dtype=np.uint8).tobytes(), b""]
    args, kw = _units(cuda, 1024, datas, span)
    _equal(psync.sync_records(*args, **kw),
           psync.sync_records_plain(*args, **kw))


def _hand_fill(recs, s, stride=3):
    row = np.full(s, -1, np.int64)
    for k, (opos, is_copy, pay) in enumerate(recs):
        row[stride * k + stride - 1] = (opos << 13) | (is_copy << 11) | pay
    return np.maximum.accumulate(row).astype(np.int32)


@pytest.mark.parametrize("out_cap", [1000, 4096])
def test_expand_kernel_status_rows(cuda, out_cap):
    s = 6144
    table = [
        (_hand_fill([(0, 0, 81), (1, 1, 1)], s), 4000),
        (_hand_fill([(k, 0, k % 251) for k in range(1999)]
                    + [(1999, 1, 1999)], s, stride=1), 4096),
        (_hand_fill([(0, 0, 65), (1, 1, 5), (9, 0, 66)], s), 100),
        (_hand_fill([(3, 0, 65), (4, 1, 1)], s), 50),
        (_hand_fill([(3, 0, 65), (4, 1, 9)], s), 50),
        (_hand_fill([(0, 0, 65)], s), 0),
    ]
    rec = torch.from_numpy(np.stack([t[0] for t in table])).to(cuda)
    n = torch.tensor([t[1] for t in table], dtype=torch.int32, device=cuda)
    got = pexpand.expand_records(rec, n, out_cap)
    _equal(got, pexpand.expand_records_plain(rec, n, out_cap))
    assert got[1].tolist() == [0, 0, 2, 3, 3, 0]


def test_codec_on_card_equals_cpu(cuda):
    rng = np.random.default_rng(5)
    lits = [c for c in range(256) if c not in (65, 66)]
    deep = b"".join(bytes([lits[k % len(lits)], 65, 66])
                    for k in range(1300))[:3900]
    data = (deep + b"Q" * 3000 + rng.integers(0, 256, 2000, dtype=np.uint8)
            .tobytes() + bytes(range(64)) * 20)
    for policy in ("greedy", "lazy"):
        gpu = BlockCodec(block=2048, policy=policy, device=cuda)
        cpu = BlockCodec(block=2048, policy=policy)
        blob = gpu.compress(data)
        assert blob == cpu.compress(data)
        assert gpu.decompress(blob) == data
        assert gpu.compress(b"") == cpu.compress(b"")
        assert gpu.decompress(gpu.compress(b"x")) == b"x"


def test_wrappers_reject_bad_operands(cuda):
    v = torch.zeros((4, 64), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        pext.cummax_rows(v[:, ::2])
    with pytest.raises(TypeError):
        pext.cummax_rows(v.to(torch.int64))
    with pytest.raises(ValueError):
        pext.cummax_rows(v[0])
    with pytest.raises(ValueError):
        ppack.pack_rows(v, v.cpu(), 64)
    with pytest.raises(ValueError, match="no units"):
        ppack.pack_rows(v[:, :0], v[:, :0], 64)
    with pytest.raises(ValueError):
        pexpand.expand_records(v, v[:, 0].contiguous(), 1 << 20)
