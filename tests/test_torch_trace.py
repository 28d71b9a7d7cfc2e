"""lzs_tpu_torch: stage spans, host spans, the profile script's device
accounting, and operand checks that must agree across devices.

The stage spans are what ``chip_smoke.py`` and ``scripts/profile_port.py``
read the pipeline through, so every stage of a real compress + decompress
must show up; the profile script must count device time as the union of
device activity intervals, attributed by launch time to the stage open on
the host. The host spans frame the compress byte APIs around the stages
(only ``wait`` inside one, ``extend``'s reads), and neither synchronise
nor reach ``stage_times()``.
"""

import datetime
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

import torch.distributed as dist

from lzs_tpu_torch import BlockCodec, parallel, trace
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


COMPRESS_STAGES = {"candidates", "extend", "units", "pack", "sync"}


def _runs_data(n: int = 6000) -> bytes:
    """Text with runs past the probe's 48-byte span, so the match search
    runs probe waves, each with its reads on the host."""
    rng = np.random.default_rng(5)
    parts = [rng.integers(97, 101, 200).astype(np.uint8).tobytes(),
             b"ab" * 300, bytes(range(256)), b"z" * 700]
    return b"".join(parts * (n // 1356 + 1))[:n]


def _spans(prof, prefix: str) -> list[tuple[str, float, float]]:
    """(name less ``prefix``, start us, end us) of the profiled spans
    whose name starts with ``prefix``, in order of start."""
    return sorted(((e.name[len(prefix):], e.time_range.start,
                    e.time_range.end) for e in prof.events()
                   if e.name.startswith(prefix)), key=lambda t: t[1])


def _profiled(fn):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("test::call"):
            fn()
    return prof


def test_host_spans_frame_the_compress_call():
    data = _runs_data()
    codec = BlockCodec(block=1024, device="cpu")
    prof = _profiled(lambda: codec.compress(data))
    (_, cs, ce), = _spans(prof, "test::")
    host = _spans(prof, "lzs_host::")
    stages = _spans(prof, "lzs::")
    assert {n for n, _, _ in host} == {"pad", "copy_in", "wait", "copy_out",
                                       "container"}
    assert all(cs <= s and e <= ce for _, s, e in host)
    assert host[0][0] == "pad"
    assert max(host, key=lambda t: t[2])[0] == "container"
    nested = 0
    for name, s, e in host:
        inside = [st for st, ss, se in stages if ss <= s and e <= se]
        assert inside in ([], ["extend"])
        assert not inside or name == "wait"
        nested += bool(inside)
        for _, ss, se in stages:  # no host span straddles a stage's edge
            assert e <= ss or s >= se or (ss <= s and e <= se)
    assert nested >= 3          # a probe wave: the loop's reads, tier 2's


def test_host_spans_of_the_distributed_compress(tmp_path):
    data = _runs_data(5000)
    parallel.initialize_distributed(
        f"file://{tmp_path / 'store'}", 1, 0, device_type="cpu",
        timeout=datetime.timedelta(seconds=120))
    try:
        codec = parallel.DistributedCodec(parallel.make_block_mesh("cpu"),
                                          block=1024)
        prof = _profiled(lambda: codec.compress(data))
    finally:
        dist.destroy_process_group()
    outside = [n for n, s, e in _spans(prof, "lzs_host::")
               if not any(ss <= s and e <= se for _, ss, se
                          in _spans(prof, "lzs::"))]
    assert outside == ["pad", "copy_in", "gather", "wait", "copy_out"]


def test_stage_times_hold_only_stages(monkeypatch):
    synced = []
    monkeypatch.setattr(trace, "_sync", lambda: synced.append(1))
    codec = BlockCodec(block=1024, device="cpu")
    with trace.stage_times() as times:
        codec.compress(_runs_data(3000))
        n = len(synced)
        with trace.host("wait"):
            pass
        assert len(synced) == n  # a host span never synchronises
    assert set(times) == COMPRESS_STAGES


@pytest.mark.parametrize("name", trace.HOST_SPANS)
def test_host_span_names_are_not_stages(name):
    def empty():
        with trace.host(name):
            pass

    prof = _profiled(empty)
    assert [n for n, _, _ in _spans(prof, "lzs_host::")] == [name]
    assert not _spans(prof, "lzs::")
    assert name not in trace.STAGES


def test_host_span_refuses_an_unknown_name():
    with pytest.raises(KeyError):
        trace.host("framing")


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
