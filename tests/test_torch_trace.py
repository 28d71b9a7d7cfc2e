"""lzs_tpu_torch: stage spans, the profile script's device accounting, and
operand checks that must agree across devices.

The stage spans are what ``chip_smoke.py`` and ``scripts/profile_port.py``
read the pipeline through, so every stage of a real compress + decompress
must show up; the profile script must count device time as the union of
device activity intervals, attributed by launch time to the stage open on
the host.
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from lzs_tpu_torch import BlockCodec, trace
from lzs_tpu_torch.blocks import pad_blocks
from lzs_tpu_torch.ops import decode, ppack

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _profile_port():
    spec = importlib.util.spec_from_file_location(
        "profile_port", ROOT / "scripts" / "profile_port.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_stage_times_cover_the_pipeline():
    data = np.random.default_rng(3).integers(97, 101, 3000).astype(
        np.uint8).tobytes()
    codec = BlockCodec(block=1024, device="cpu")
    with trace.stage_times() as times:
        assert codec.decompress(codec.compress(data)) == data
    assert set(times) == set(trace.STAGES)
    assert all(t >= 0 for t in times.values())
    with trace.stage("pack"):
        pass                     # outside stage_times: nothing collected
    assert trace._times is None


def test_raw_stage_times_cover_the_raw_decoder():
    data = np.random.default_rng(4).integers(97, 101, 3000).astype(
        np.uint8).tobytes()
    codec = BlockCodec(block=1024, device="cpu")
    x, lens = pad_blocks(data, 1024)
    comp, clen, _, _, _ = codec.encode_batch(torch.from_numpy(x),
                                             torch.from_numpy(lens))
    with trace.stage_times() as times:
        out, out_len, _ = codec.decode_batch_raw(comp, clen)
    assert set(times) == set(trace.RAW_STAGES)
    assert not set(trace.RAW_STAGES) & set(trace.STAGES)
    assert out_len.tolist() == lens.tolist()
    assert b"".join(out[i, :m].numpy().tobytes()
                    for i, m in enumerate(lens)) == data


def test_scan_stage_times_cover_the_scan_decoder():
    data = np.random.default_rng(4).integers(97, 101, 3000).astype(
        np.uint8).tobytes()
    codec = BlockCodec(block=1024, device="cpu")
    x, lens = pad_blocks(data, 1024)
    comp, clen, _, _, _ = codec.encode_batch(torch.from_numpy(x),
                                             torch.from_numpy(lens))
    with trace.stage_times() as times:
        out, out_len, _ = decode.decode_batch(comp, clen, out_cap=1024,
                                              engine="scan")
    assert set(times) == set(trace.SCAN_STAGES)
    assert not set(trace.SCAN_STAGES) & (set(trace.STAGES)
                                         | set(trace.RAW_STAGES))
    assert out_len.tolist() == lens.tolist()
    assert b"".join(out[i, :m].numpy().tobytes()
                    for i, m in enumerate(lens)) == data


def test_stage_spans_reach_the_profiler():
    data = bytes(range(256)) * 8
    codec = BlockCodec(block=1024, device="cpu")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        codec.decompress(codec.compress(data))
    names = {e.name for e in prof.events()}
    assert {f"lzs::{s}" for s in trace.STAGES} <= names


@pytest.mark.parametrize("intervals, want", [
    ([], 0.0),
    ([(0, 10), (5, 15)], 15.0),           # overlap counts once
    ([(0, 10), (2, 3), (20, 25)], 15.0),  # nested, then a gap
    ([(5, 6), (0, 1)], 2.0),              # unsorted
])
def test_union_of_device_intervals(intervals, want):
    assert _profile_port()._union_us(intervals) == want


def test_device_summary_attributes_by_launch():
    ev = [
        {"cat": "user_annotation", "name": "lzs::parse", "ts": 0, "dur": 100},
        {"cat": "user_annotation", "name": "lzs::fill", "ts": 100,
         "dur": 50},
        {"cat": "cpu_op", "name": "aten::where", "ts": 1, "dur": 90},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 10,
         "dur": 2, "args": {"correlation": 1}},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 20,
         "dur": 2, "args": {"correlation": 2}},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 120,
         "dur": 2, "args": {"correlation": 3}},
        {"cat": "kernel", "name": "k_a", "ts": 200, "dur": 10,
         "args": {"correlation": 1}},
        {"cat": "kernel", "name": "k_a", "ts": 205, "dur": 10,
         "args": {"correlation": 2}},
        {"cat": "gpu_memcpy", "name": "copy", "ts": 300, "dur": 4,
         "args": {"correlation": 3}},
        {"cat": "gpu_memset", "name": "set", "ts": 400, "dur": 1,
         "args": {"correlation": 99}},
        {"cat": "gpu_user_annotation", "name": "lzs::parse", "ts": 200,
         "dur": 15},
    ]
    out = _profile_port().device_summary(ev)
    assert out["activities"] == 4
    assert out["busy_ms"] == pytest.approx(0.020)
    assert out["stages"] == {"fill": 0.004, "other": 0.001, "parse": 0.015}
    assert out["top"][0] == ["k_a", 0.02]


@pytest.mark.parametrize("b", [0, 3])
def test_pack_rows_rejects_rows_without_units(b):
    z = torch.zeros((b, 0), dtype=torch.int32)
    with pytest.raises(ValueError, match="no units"):
        ppack.pack_rows(z, z, 64)
