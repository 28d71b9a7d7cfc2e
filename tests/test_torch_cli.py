"""lzs_tpu_torch.cli against the JAX package's CLI contract, on the CPU.

* Counterparts of ``tests/test_coders_cli.py``'s CLI tests and of
  ``tests/test_blocks_dist.py::test_cli_lazy_flag``, run with
  ``--device cpu``. The cross-reference check reads the port's output
  with the port's C decoder (``utils.native``), not the reference tree.
* The output files against the JAX package: raw blocks and ``--stream``
  equal ``lzs_tpu.reference.lzs_compress`` block by block and one-shot
  (JAX's own tests show that its CLI writes those bytes); ``--container``
  and ``--container --lazy`` equal JAX's ``BlockCodec(block=4096)``
  bytes, computed once in a module fixture.
* The raw decode runs on the device (here the CPU) at every size: past
  2^18 output bytes and past 16 times the input, where JAX's CLI hands
  the stream to its host decoder, past the raw decoder's input window
  (cut to a few KiB) and past ``MAX_WIDE_OUT_CAP`` (cut too), it never
  reaches the host; an error on the device path propagates.
"""

import contextlib
import io
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from lzs_tpu import reference as jref
from lzs_tpu.blocks import BlockCodec as JBlockCodec
from lzs_tpu_torch import cli
from lzs_tpu_torch.blocks import FLAG_LAZY
from lzs_tpu_torch.ops import bitpar, pwalk
from lzs_tpu_torch.utils import native

from test_blocks_dist import make_corpus
from test_stream import mixed_data

REPO = pathlib.Path(__file__).resolve().parent.parent
DATA = mixed_data(9, 8000)
CPU = ["--device", "cpu"]


def run(tmp_path, argv, data: bytes, name: str = "out") -> tuple[bytes, str]:
    """cli.main(argv + [in, out]) on ``data``; (output bytes, stderr)."""
    src, dst = tmp_path / f"{name}.in", tmp_path / name
    src.write_bytes(data)
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        assert cli.main(argv + [str(src), str(dst)]) == 0
    return dst.read_bytes(), err.getvalue()


def decompress(tmp_path, blob: bytes, *flags) -> tuple[bytes, str]:
    return run(tmp_path, ["decompress", "-v", *CPU, *flags], blob, "back")


@pytest.fixture(scope="module")
def jax_containers():
    """JAX's container bytes of DATA at block 4096, greedy and lazy."""
    return {policy: JBlockCodec(block=4096, policy=policy).compress(DATA)
            for policy in ("greedy", "lazy")}


def test_cli_raw_roundtrip(tmp_path):
    comp, _ = run(tmp_path, ["compress", *CPU], DATA)
    assert comp == jref.lzs_compress(DATA)
    back, err = decompress(tmp_path, comp)
    assert back == DATA
    assert "route: device" in err


def test_cli_raw_blocks_match_reference(tmp_path):
    comp, _ = run(tmp_path, ["compress", "--blocks", "--block", "2048", *CPU],
                  DATA)
    assert comp == b"".join(jref.lzs_compress(DATA[s:s + 2048])
                            for s in range(0, len(DATA), 2048))
    assert decompress(tmp_path, comp)[0] == DATA


def test_cli_stream_matches_reference(tmp_path):
    comp, _ = run(tmp_path, ["compress", "--stream", "--block", "3000", *CPU],
                  DATA)
    assert comp == jref.lzs_compress(DATA)
    assert decompress(tmp_path, comp)[0] == DATA


def test_cli_stream_lazy_exits(tmp_path):
    with pytest.raises(SystemExit, match="--lazy"):
        run(tmp_path, ["compress", "--stream", "--lazy", *CPU], DATA)


@pytest.mark.parametrize("policy", ["greedy", "lazy"])
def test_cli_container_roundtrip(tmp_path, jax_containers, policy):
    flags = ["--lazy"] if policy == "lazy" else []
    comp, _ = run(tmp_path, ["compress", "--container", "--block", "4096",
                             *flags, *CPU], DATA)
    assert comp[:4] == b"LZST"
    assert comp == jax_containers[policy]
    back, err = decompress(tmp_path, comp)
    assert back == DATA
    assert "route: device, container" in err
    assert decompress(tmp_path, comp, "--container")[0] == DATA


def test_cli_lazy_flag(tmp_path):
    data = make_corpus(6000, seed=11)
    blob, _ = run(tmp_path, ["compress", "--container", "--lazy", "--block",
                             "2048", *CPU], data)
    assert blob[5] & FLAG_LAZY
    assert decompress(tmp_path, blob)[0] == data


def test_cli_cross_reference(tmp_path):
    comp, _ = run(tmp_path, ["compress", *CPU], DATA[:5000])
    assert native.decompress(comp, out_cap=5000) == DATA[:5000]
    comp, _ = run(tmp_path, ["compress", "--block", "1024", *CPU],
                  DATA[:5000])
    assert native.decompress(comp, out_cap=5000,
                             multi_stream=True) == DATA[:5000]


@pytest.fixture
def no_host_decode(monkeypatch):
    """Fail any call of the host's stream decoder."""
    from lzs_tpu_torch import stream

    def host(*args, **kw):
        raise AssertionError("the raw decode reached the host decoder")

    monkeypatch.setattr(stream, "decompress_stream", host)
    monkeypatch.setattr(stream, "StreamDecompressor", host)


def test_cli_device_route_past_2_18(tmp_path, no_host_decode):
    """A raw stream over 2^16 bytes decodes to some 70000 bytes; a first
    out_cap from 4 times its input is past 2^18, where JAX's CLI decodes
    it on the host: it decodes on the device to the input."""
    data = np.random.default_rng(3).integers(0, 256, 70000,
                                             dtype=np.uint8).tobytes()
    comp = native.compress(data)
    assert len(comp) > 1 << 16
    back, err = decompress(tmp_path, comp)
    assert back == data
    assert "route: device\n" in err


def test_cli_device_route_past_16x(tmp_path, monkeypatch, no_host_decode):
    """Zeros expand some 30 times, past 16 times the input (where JAX's
    CLI goes to the host): the stream decodes on the device, each
    window's records expanded there with no output capacity."""
    data = bytes(60000)
    comp = native.compress(data)
    lens = []
    expand = bitpar._expand_windows

    def spy(opos, length, low, kept, n, *args):
        lens.extend(n)
        assert opos.device.type == "cpu"
        return expand(opos, length, low, kept, n, *args)

    monkeypatch.setattr(bitpar, "_expand_windows", spy)
    back, err = decompress(tmp_path, comp)
    assert back == data
    assert "route: device\n" in err
    assert sum(lens) == len(data) > 16 * len(comp)


def _windows(monkeypatch, win: int, margin: int = 256) -> list[int]:
    """Cut the raw decoder's input window to ``win`` bytes behind
    ``margin``; the spans of the windows it takes are appended to the
    list returned."""
    spans = []
    heads = bitpar._heads

    def spy(comp, *args, **kw):
        spans.append(comp.shape[1])
        return heads(comp, *args, **kw)

    monkeypatch.setattr(bitpar, "_WIN", win)
    monkeypatch.setattr(bitpar, "_MARGIN", margin)
    monkeypatch.setattr(bitpar, "_heads", spy)
    return spans


def test_cli_raw_past_the_window(tmp_path, monkeypatch, no_host_decode):
    """A raw file of blocks past the raw decoder's input window (cut to 2
    KiB; text and noise, so the file is some 10 KB) decodes on the
    device, window by window, to the input."""
    spans = _windows(monkeypatch, 2048)
    data = DATA + np.random.default_rng(4).integers(
        0, 256, 9000, dtype=np.uint8).tobytes()
    comp, _ = run(tmp_path, ["compress", "--block", "2048", *CPU], data)
    assert len(comp) > 4 * 2048
    back, err = decompress(tmp_path, comp)
    assert back == data
    assert "route: device\n" in err
    assert len(spans) >= len(comp) // (2048 + 256)


def test_cli_raw_past_max_wide_out_cap(tmp_path, monkeypatch,
                                       no_host_decode):
    """The CLI's raw decode has no output capacity: with the decoder's
    widest out_cap cut to 4096 bytes, a raw file of 8000 bytes of output
    (over windows of the input) decodes on the device to the input."""
    monkeypatch.setattr(bitpar, "MAX_WIDE_OUT_CAP", 4096)
    spans = _windows(monkeypatch, 128)
    comp = jref.lzs_compress(DATA)
    assert len(DATA) > bitpar.MAX_WIDE_OUT_CAP
    back, err = decompress(tmp_path, comp)
    assert back == DATA
    assert "route: device\n" in err
    assert len(spans) > 1


@pytest.mark.parametrize("offset", [1, 200, 2047])
def test_cli_long_token_equals_jax_cli(tmp_path, monkeypatch,
                                       no_host_decode, offset):
    """A raw file that is one long copy (a run of 400 15-nibbles, some 3
    of the raw decoder's input windows, cut to 64 new bytes behind 16 of
    margin), short and long offsets: the port's CLI decodes it on the
    device, each window's share of the run a record of its own, to the
    bytes of the JAX package's CLI and of the copy rule. At offset 1
    (one literal before the copy) the output passes 16 times the input,
    where JAX's CLI decodes on its host decoder."""
    from lzs_tpu import cli as jcli
    from test_torch_rawdecode import long_token

    spans = _windows(monkeypatch, 64, 16)
    comp, want = long_token(offset, 400, 3, 3)
    back, err = decompress(tmp_path, comp)
    assert "route: device\n" in err
    src, dst = tmp_path / "jax.in", tmp_path / "jax.out"
    src.write_bytes(comp)
    assert jcli.main(["decompress", str(src), str(dst)]) == 0
    assert back == dst.read_bytes() == want
    assert (len(want) > 16 * len(comp)) == (offset == 1)
    assert max(spans) <= 64 + 16 and len(spans) > len(comp) // 80


def test_cli_device_errors_propagate(tmp_path, monkeypatch):
    def fails(*args, **kw):
        raise RuntimeError("device failure")

    monkeypatch.setattr(pwalk, "walk_starts", fails)
    with pytest.raises(RuntimeError, match="device failure"):
        decompress(tmp_path, jref.lzs_compress(DATA))


def test_cli_defaults_to_the_card():
    parser = cli.build_parser()
    for cmd in ("compress", "decompress"):
        assert parser.parse_args([cmd, "a", "b"]).device == "cuda"


def test_main_compress_and_decompress(tmp_path):
    src, comp, back = (tmp_path / n for n in ("in", "comp", "back"))
    src.write_bytes(DATA)
    assert cli.main_compress([*CPU, str(src), str(comp)]) == 0
    assert comp.read_bytes() == jref.lzs_compress(DATA)
    assert cli.main_decompress([*CPU, str(comp), str(back)]) == 0
    assert back.read_bytes() == DATA


def test_cli_module_subprocess(tmp_path):
    src, comp, back = (tmp_path / n for n in ("in", "comp", "back"))
    src.write_bytes(DATA)
    for argv in (["compress", str(src), str(comp)],
                 ["decompress", str(comp), str(back)]):
        res = subprocess.run(
            [sys.executable, "-m", "lzs_tpu_torch.cli", *argv, *CPU],
            capture_output=True, text=True, timeout=300, cwd=REPO)
        assert res.returncode == 0, res.stderr
    assert comp.read_bytes() == jref.lzs_compress(DATA)
    assert back.read_bytes() == DATA
