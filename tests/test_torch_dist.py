"""lzs_tpu_torch.parallel on gloo CPU groups against the JAX package's
DistributedCodec.

Counterparts of ``tests/test_blocks_dist.py``'s DistributedCodec tests
(``test_mesh_has_8_devices`` becomes the world size) on worlds of 1 (in
this process), 2 and 8 (spawned ranks, ``torch_dist_ranks``). One group
per world size: a module fixture runs every check's calls in the ranks
and returns each rank's results. The payload, ``clens``, ``sbit``,
``sout`` and ``nsync`` equal JAX's ``DistributedCodec`` on the 8 virtual
CPU devices of ``tests/conftest.py`` (run once, in a module fixture)
for ``make_corpus(20000, seed=9)`` at block 1024, uneven blocks
(3 x 1024 + 17 bytes) and empty input; every rank holds the same
results, and the decompress is exact.
"""

import datetime
import inspect

import numpy as np
import pytest
import torch.distributed as dist

from lzs_tpu import reference as jref
from lzs_tpu.parallel import DistributedCodec as JDistributedCodec
from lzs_tpu.parallel import make_block_mesh as jmake_block_mesh
from lzs_tpu_torch import parallel

from test_blocks_dist import make_corpus
from torch_dist_ranks import BLOCK, TIMEOUT_S, codec_results, spawn_world

CASES = {"corpus": make_corpus(20000, seed=9),
         "uneven": make_corpus(1024 * 3 + 17, seed=11),
         "empty": b""}
WORLDS = [1, 2, 8]


@pytest.fixture(scope="module")
def jax_results():
    codec = JDistributedCodec(jmake_block_mesh(), block=BLOCK)
    assert codec.ndev == 8
    out = {}
    for name, data in CASES.items():
        payload, clens, sbit, sout, nsync = codec.compress(data)
        out[name] = (payload, clens, np.asarray(sbit), np.asarray(sout),
                     np.asarray(nsync))
    return out


@pytest.fixture(scope="module", params=WORLDS)
def ranks(request, tmp_path_factory):
    """(world, every rank's codec_results) for one world size."""
    world = request.param
    store = str(tmp_path_factory.mktemp(f"world{world}") / "store")
    if world > 1:
        return world, spawn_world(world, store, CASES)
    parallel.initialize_distributed(
        f"file://{store}", 1, 0, device_type="cpu",
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        parallel.initialize_distributed(device_type="cpu")  # idempotent
        return world, [codec_results(CASES)]
    finally:
        dist.destroy_process_group()


def test_mesh_size_is_the_world(ranks):
    world, results = ranks
    assert [r["ndev"] for r in results] == [world] * world


@pytest.mark.parametrize("case", sorted(CASES))
def test_distributed_matches_jax(ranks, jax_results, case):
    _, results = ranks
    want = jax_results[case]
    for r in results:
        payload, clens, sbit, sout, nsync, _ = r["cases"][case]
        assert payload == want[0]
        assert clens == want[1]
        for got, ref in zip((sbit, sout, nsync), want[2:], strict=True):
            assert got.dtype == np.int32
            np.testing.assert_array_equal(got, ref)


def test_distributed_matches_single_chip(ranks):
    data = CASES["corpus"]
    expect = b"".join(jref.lzs_compress(data[s:s + BLOCK])
                      for s in range(0, len(data), BLOCK))
    for r in ranks[1]:
        payload, *_, back = r["cases"]["corpus"]
        assert payload == expect
        assert back == data


def test_distributed_uneven_blocks(ranks):
    for r in ranks[1]:
        payload, clens, *_, back = r["cases"]["uneven"]
        assert len(clens) == 4
        assert back == CASES["uneven"]


def test_distributed_empty_input(ranks):
    for r in ranks[1]:
        payload, clens, *_, back = r["cases"]["empty"]
        assert len(clens) == 1 and back == b""
        assert payload == jref.lzs_compress(b"")


def test_encode_sharded_refuses_an_uneven_batch(ranks):
    world, results = ranks
    for r in results:
        if world == 1:
            assert r["uneven_batch"] == "accepted"
        else:
            assert "not a multiple of the mesh size" in r["uneven_batch"]


def test_defaults_to_the_card():
    for fn in (parallel.make_block_mesh, parallel.initialize_distributed):
        assert inspect.signature(fn).parameters[
            "device_type"].default == "cuda"
    assert parallel.dist.AXIS == "blocks"
