"""lzs_tpu_torch: copy expansion (pexpand) against the JAX package.

``lzs_tpu.ops.pexpand.expand_records`` (its Pallas kernel in interpret
mode) and the port's ``expand_records`` (plain version on CPU tensors)
get the same filled record rows and must give the same bytes and status
words (tolerance 0). Rows: the real records of the deep copy-chain block
of tests/test_sync_decode.py, hand-made records for a long single-record
copy, a copy source before the block start (status bit 1) and bytes
with no covering record (status bit 0, which the TPU kernel reports with
bit 1 as well). The generated rows of test_torch_cases.expand_batch (one
record over many chunks, copy chains up to chunk boundaries, the widest
record windows at span 160, 768 slots, out_cap 1000 and 32767) are held
to JAX the same way.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lzs_tpu.ops import pexpand as jpexpand
from lzs_tpu_torch.ops import decode2, encode, pexpand

from test_torch_cases import expand_batch

BLOCK = 4096
SPAN = 2048


def _deep_chain() -> bytes:
    lits = [c for c in range(256) if c not in (65, 66)]
    return b"".join(bytes([lits[k % len(lits)], 65, 66])
                    for k in range(1300))[:3900]


def _real_fill(data: bytes) -> np.ndarray:
    """Filled records of one block, made by the port's encoder and lane
    parse (both pinned to JAX in test_torch_sync / test_torch_decode)."""
    x = np.zeros((1, BLOCK), np.uint8)
    x[0, :len(data)] = np.frombuffer(data, np.uint8)
    n = torch.tensor([len(data)], dtype=torch.int32)
    comp, _, sbit, sout, _ = encode.encode_batch_sync(
        torch.from_numpy(x), n, span=SPAN)
    recs, _ = decode2._parse_full(comp, sbit, sout, SPAN)
    return decode2._filled_records(recs)[0].numpy()


def _hand_fill(recs, s: int, stride: int = 3) -> np.ndarray:
    """Records (opos, is_copy, payload) at every ``stride``-th slot, -1
    between, cummax-filled as decode2._filled_records leaves them."""
    row = np.full(s, -1, np.int64)
    for k, (opos, is_copy, pay) in enumerate(recs):
        row[stride * k + stride - 1] = (opos << 13) | (is_copy << 11) | pay
    return np.maximum.accumulate(row).astype(np.int32)


@pytest.fixture(scope="module")
def rows():
    deep = _deep_chain()
    fill = _real_fill(deep)
    s = fill.shape[0]
    table = [
        (fill, len(deep), 0),
        (_hand_fill([(0, 0, ord("Q")), (1, 1, 1)], s), 4000, 0),
        (_hand_fill([(0, 0, 7), (1, 0, 8), (2, 0, 9), (3, 1, 3)], s), 4096, 0),
        (_hand_fill([(k, 0, k % 251) for k in range(1999)] + [(1999, 1, 1999)],
                    s, stride=1), 4096, 0),
        (_hand_fill([(0, 0, 65), (1, 1, 5), (9, 0, 66)], s), 100, 2),
        (_hand_fill([(3, 0, 65), (4, 1, 1)], s), 50, 3),
        (_hand_fill([(3, 0, 65), (4, 1, 9)], s), 50, 3),
        (_hand_fill([(0, 0, 65)], s), 0, 0),
    ]
    recfill = np.stack([t[0] for t in table])
    n = np.array([t[1] for t in table], np.int32)
    status = np.array([t[2] for t in table], np.int32)
    return recfill, n, status, deep


def test_expand_records_matches_jax(rows):
    recfill, n, status, deep = rows
    want_out, want_st = jpexpand.expand_records(
        jnp.asarray(recfill), jnp.asarray(n), BLOCK)
    got_out, got_st = pexpand.expand_records(
        torch.from_numpy(recfill), torch.from_numpy(n), BLOCK)
    np.testing.assert_array_equal(got_out.numpy(),
                                  np.asarray(want_out).astype(np.uint8))
    np.testing.assert_array_equal(got_st.numpy(), np.asarray(want_st))
    np.testing.assert_array_equal(got_st.numpy(), status)
    assert got_out[0, :len(deep)].numpy().tobytes() == deep
    assert got_out[1, :4000].numpy().tobytes() == b"Q" * 4000
    assert got_out[2, :9].tolist() == [7, 8, 9] * 3
    assert got_out[3].tolist() == [k % 1999 % 251 for k in range(BLOCK)]


def test_expand_records_plain_is_the_cpu_path(rows):
    recfill, n, _, _ = rows
    a = pexpand.expand_records(torch.from_numpy(recfill),
                               torch.from_numpy(n), 1000)
    b = pexpand.expand_records_plain(torch.from_numpy(recfill),
                                     torch.from_numpy(n), 1000)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_expand_zero_fills_past_n(rows):
    recfill, n, _, _ = rows
    out, _ = pexpand.expand_records(torch.from_numpy(recfill),
                                    torch.from_numpy(n), BLOCK)
    for row, m in zip(out.numpy(), n):
        assert not row[m:].any()


@pytest.mark.parametrize("slots", [768, None])
@pytest.mark.parametrize("out_cap", [1000, 32767])
def test_expand_edge_rows_match_jax(out_cap, slots):
    rec, n = expand_batch(out_cap, out_cap, slots)
    want_out, want_st = jpexpand.expand_records(jnp.asarray(rec),
                                                jnp.asarray(n), out_cap)
    got_out, got_st = pexpand.expand_records(torch.from_numpy(rec),
                                             torch.from_numpy(n), out_cap)
    np.testing.assert_array_equal(got_out.numpy(),
                                  np.asarray(want_out).astype(np.uint8))
    np.testing.assert_array_equal(got_st.numpy(), np.asarray(want_st))
    assert {0, 2, 3} <= set(got_st.tolist())
    period1 = got_out[0, :min(out_cap, 4096)].numpy()
    assert (period1 == period1[0]).all()
