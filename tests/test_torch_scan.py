"""lzs_tpu_torch: row scans (pext), the jax-free import and the spec.

The port's scans on CPU tensors (their plain versions) against the JAX
package's Pallas roll-scan kernels in interpret mode, on the same int32
inputs made from a seed; exact equality (integers, tolerance 0). The
match extension's fused scans (K4 ``ext_breaks``, K5 ``ext_fold``) read
(score, off) from JAX's ``candidates`` on the blocks of
tests/test_torch_pcand.py and ``ext_h`` from the port's probe; the probe
rank (K6 ``rank_mask``) is held to JAX's on seeded masks. The port's
whole package imports no jax, and every public name of the JAX package
has its counterpart in the port (by AST) but for the names that ROADMAP
leaves out.
"""

import ast
import dataclasses
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lzs_tpu import spec as jspec
from lzs_tpu.ops import pext as jpext
from lzs_tpu.ops import sortmatch as jsm
from lzs_tpu_torch import spec as tspec
from lzs_tpu_torch.ops import pext, sortmatch

from test_torch_cases import (FOLD_CAP, breaks_rows, cumsum_rows,
                              fold_rows, minmax_rows)
from test_torch_pcand import mixed_blocks

REPO = pathlib.Path(__file__).resolve().parent.parent


def _rows(seed: int, b: int, w: int) -> np.ndarray:
    """int32 rows with negative values and the -1 / 0x3FFFFFFF sentinels."""
    rng = np.random.default_rng(seed)
    v = rng.integers(-(1 << 20), 1 << 20, (b, w), dtype=np.int64)
    pick = rng.random((b, w))
    v[pick < 0.15] = -1
    v[pick > 0.85] = 0x3FFFFFFF
    return v.astype(np.int32)


@pytest.mark.parametrize("b,w", [(8, 1024), (32, 128), (3, 777), (1, 1),
                                 (33, 1024), (33, 8193), (2, 16417)])
def test_scans_match_jax_pext(b, w):
    v = _rows(b * 1000 + w, b, w)
    got_max = pext.cummax_rows(torch.from_numpy(v)).numpy()
    got_min = pext.rcummin_rows(torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(
        got_max, np.asarray(jpext.cummax_rows(jnp.asarray(v))))
    np.testing.assert_array_equal(
        got_min, np.asarray(jpext.rcummin_rows(jnp.asarray(v))))


@pytest.mark.parametrize("b,w", [(33, 4097), (3, 16417), (6, 1)])
def test_minmax_rows_match_jax_pext(b, w):
    """Batch >= 32 (F4) and multi-tile widths, on rows that rise, fall and
    are shuffled, with INT_MIN, INT_MAX, -1 and 0x3FFFFFFF in every row
    (the rows the card's tests give K7 and K8)."""
    v = minmax_rows(b + w, b, w)
    np.testing.assert_array_equal(
        pext.cummax_rows(torch.from_numpy(v)).numpy(),
        np.asarray(jpext.cummax_rows(jnp.asarray(v))))
    np.testing.assert_array_equal(
        pext.rcummin_rows(torch.from_numpy(v)).numpy(),
        np.asarray(jpext.rcummin_rows(jnp.asarray(v))))


@pytest.mark.parametrize("w,tile", [(1000, 8192), (4096, 1024)])
def test_cumsum_rows_wide_matches_jax_pext(w, tile):
    # batch 32 (F4); the 0x3FFFFFFF entries make the sums wrap like int32
    v = _rows(w + tile, 32, w)
    got = pext.cumsum_rows_wide(torch.from_numpy(v), tile=tile)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jpext.cumsum_rows_wide(jnp.asarray(v),
                                                      tile=tile)))


@pytest.mark.parametrize("b,w,tile", [(32, 4096, 1024), (33, 1024, 8192),
                                      (40, 2048, 512)])
def test_cumsum_rows_wide_wraps_like_jax_pext(b, w, tile):
    """Batch >= 32 (F4), values near +-2^31: the sums wrap many times in
    every row and every JAX tile (the rows the card's tests take too)."""
    v = cumsum_rows(b + w + tile, b, w)
    got = pext.cumsum_rows_wide(torch.from_numpy(v), tile=tile)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jpext.cumsum_rows_wide(jnp.asarray(v),
                                                      tile=tile)))
    assert (got.numpy() < 0).any() and (got.numpy() > 0).any()


@pytest.mark.parametrize("b,npos,tile", [
    (1, 1, 4096), (1, 89216, 4096), (4, 200704, 4096), (1, 1 << 20, 4096),
    (33, 33792, 4096), (106, 33792, 8192), (105, 33792, 4096),
    (256, 33792, 8192), (1024, 75776, 8192), (1024, 1025, 8192),
    (0, 5, 4096)])
def test_cumsum_tile(b, npos, tile):
    """The paths' shapes at 132 SMs: the wide tile where the rows make at
    least 4 of them per SM (528: 106 x 5 does, 105 x 5 does not), the
    narrow one (twice the CTAs) for the 2^18 decode_block's few rows."""
    assert pext.cumsum_tile(b, npos, 132) == tile
    assert tile in pext.SUM_TILES


def _ext_h(x, n, packed, off, cap=12):
    """ext_h as the port's _extend_batch builds it: the probe where
    need_probe is set, ext_res elsewhere."""
    need = (packed & 1) != 0
    probe = sortmatch._probe_batch(x, n, off, need, cap)
    return torch.where(need, probe, packed >> 3)


#: (b, npos, source): the match search's own (score, off) on mixed blocks,
#: and the seeded fold and breaks rows of tests/test_torch_cases.py
#: (capped runs over the chained scan's 4096- and 8192-element tiles,
#: heads at lane, warp and tile starts, n past the row and n = 0, cap +
#: ext_h at and past 0xFFFF, ragged widths), which the gpu tests feed to
#: the kernels too
ROWS = {"fold_rows": fold_rows, "breaks_rows": breaks_rows}
FOLD_CASES = [pytest.param(b, npos, "blocks", id=f"{b}-{npos}")
              for b in (3, 8, 32) for npos in (512, 1024)] + [
    pytest.param(33, 8195, "fold_rows", id="fold_rows-33-8195"),
    pytest.param(3, 12290, "fold_rows", id="fold_rows-3-12290"),
    pytest.param(7, 32768, "breaks_rows", id="breaks_rows-7-32768"),
    pytest.param(4, 16401, "breaks_rows", id="breaks_rows-4-16401"),
    pytest.param(33, 4099, "breaks_rows", id="breaks_rows-33-4099")]


@pytest.mark.parametrize("b,npos,source", FOLD_CASES)
def test_ext_breaks_and_fold_match_jax_pext(b, npos, source):
    if source == "blocks":
        x, n = mixed_blocks(b * npos, b, npos)
        xj, nj = jnp.asarray(x), jnp.asarray(n)
        score, off = jax.jit(jax.vmap(lambda a, m: jsm.candidates(a, m)))(
            xj, nj)
        score, off = np.array(score), np.array(off)
    else:
        score, off, n, ext_h = ROWS[source](npos, b, npos)
    st, ot = torch.from_numpy(score), torch.from_numpy(off)
    want = np.asarray(jpext.ext_breaks(jnp.asarray(score), jnp.asarray(off),
                                       jnp.asarray(n), FOLD_CAP))
    packed = pext.ext_breaks(st, ot, torch.from_numpy(n), FOLD_CAP)
    np.testing.assert_array_equal(packed.numpy(), want)
    assert ((packed & 1) != 0).any() and ((packed & 4) != 0).any()
    if source == "blocks":
        ext_h = _ext_h(torch.from_numpy(x), torch.from_numpy(n), packed, ot)
    else:
        ext_h = torch.from_numpy(ext_h)
    full = pext.ext_fold(packed, ext_h, st, FOLD_CAP)
    np.testing.assert_array_equal(
        full.numpy(), np.asarray(jpext.ext_fold(
            jnp.asarray(want), jnp.asarray(ext_h.numpy()),
            jnp.asarray(score), FOLD_CAP)))
    assert full.numpy().max() > FOLD_CAP


@pytest.mark.parametrize("b", [3, 32])
def test_ext_breaks_capped_head_at_row_end(b):
    """n past the row end lets the last position be a capped head: its
    next break lies past the row (JAX's 0x3FFFFFFF, the kernel's INT_MAX)."""
    rng = np.random.default_rng(b)
    npos = 512
    score = rng.integers(0, 13, (b, npos))
    score[rng.random((b, npos)) < 0.6] = 12
    off = rng.integers(1, 4, (b, npos))
    score[:, -3:] = 12
    off[:, -3:] = [5, 5, 7]
    n = rng.integers(5, npos + 40, b)
    n[0], n[1] = npos + 20, npos + 11
    score, off, n = (a.astype(np.int32) for a in (score, off, n))
    want = np.asarray(jpext.ext_breaks(jnp.asarray(score), jnp.asarray(off),
                                       jnp.asarray(n), 12))
    packed = pext.ext_breaks(torch.from_numpy(score), torch.from_numpy(off),
                             torch.from_numpy(n), 12)
    np.testing.assert_array_equal(packed.numpy(), want)
    assert int(packed[0, -1]) & 0b110 == 0b110          # capped head at N - 1
    ext_h = rng.integers(0, 100, (b, npos)).astype(np.int32)
    np.testing.assert_array_equal(
        pext.ext_fold(packed, torch.from_numpy(ext_h),
                      torch.from_numpy(score), 12).numpy(),
        np.asarray(jpext.ext_fold(jnp.asarray(want), jnp.asarray(ext_h),
                                  jnp.asarray(score), 12)))


@pytest.mark.parametrize("b,w", [(8, 1024), (32, 128), (3, 777), (32, 1),
                                 (33, 3), (33, 4095), (33, 8193)])
def test_rank_mask_matches_jax_pext(b, w):
    rng = np.random.default_rng(b + w)
    mask = rng.random((b, w)) < rng.random((b, 1))
    mask[0] = True
    mask[-1] = False
    got = pext.rank_mask(torch.from_numpy(mask))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jpext.rank_mask(jnp.asarray(mask))))


def test_scan_plain_versions_are_the_cpu_path():
    v = torch.from_numpy(_rows(5, 4, 300))
    assert torch.equal(pext.cummax_rows(v), pext.cummax_rows_plain(v))
    assert torch.equal(pext.rcummin_rows(v), pext.rcummin_rows_plain(v))
    assert torch.equal(pext.cumsum_rows_wide(v), pext.cumsum_rows_plain(v))
    assert torch.equal(pext.rank_mask(v > 0), pext.rank_mask_plain(v > 0))
    n = torch.tensor([300, 200, 17, 0], dtype=torch.int32)
    score = (v & 15).clamp(max=12)
    packed = pext.ext_breaks(score, v & 7, n, 12)
    assert torch.equal(packed, pext.ext_breaks_plain(score, v & 7, n, 12))
    assert torch.equal(pext.ext_fold(packed, v & 63, score, 12),
                       pext.ext_fold_plain(packed, v & 63, score, 12))


def test_scan_rejects_unsupported_device():
    v = torch.zeros((2, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        pext.cummax_rows(v)


def test_port_imports_no_jax():
    """Every module of the port (walked, not listed),
    ``scripts/kernel_bench.py`` and the ``chip_smoke.py`` it imports import
    neither jax nor the JAX package."""
    code = ("import importlib, pkgutil, sys\n"
            "import lzs_tpu_torch\n"
            "mods = [m.name for m in pkgutil.walk_packages(\n"
            "    lzs_tpu_torch.__path__, 'lzs_tpu_torch.')]\n"
            "for name in mods:\n"
            "    importlib.import_module(name)\n"
            "import runpy\n"
            "runpy.run_path('scripts/kernel_bench.py')\n"
            "lzs_tpu_torch.StreamCompressor, lzs_tpu_torch.GeneralCodec\n"
            "for m in ('coders', 'models.profiles', 'cli', 'parallel.dist'):\n"
            "    assert 'lzs_tpu_torch.' + m in mods, m\n"
            "assert 'jax' not in sys.modules, sorted(sys.modules)\n"
            "assert 'lzs_tpu' not in sys.modules\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=REPO)
    assert res.returncode == 0, res.stderr


#: public names of the JAX package that the port leaves out on purpose
#: (ROADMAP's "Do not port" paragraph and Queue 1 item 2's TPU-form
#: internals), by module
NOT_PORTED = {
    "ops/vgather.py": {"mxu_gather", "mxu_gather_wide", "mxu_span_gather"},
    "ops/ppack.py": {"pack_phase"},
    "ops/psync.py": {"sync_keys"},
    "ops/sortmatch.py": {"small_extension"},
}


def _top_level(tree: ast.Module):
    """A module's top-level statements, those in top-level if / try too."""
    for node in tree.body:
        yield node
        if isinstance(node, ast.If):
            yield from node.body
            yield from node.orelse
        elif isinstance(node, ast.Try):
            yield from node.body
            for handler in node.handlers:
                yield from handler.body


def _all(tree: ast.Module):
    for node in _top_level(tree):
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__"
                for t in node.targets):
            return set(ast.literal_eval(node.value))
    return None


def _bound(node) -> set[str]:
    """Names a top-level definition or assignment binds."""
    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                         ast.ClassDef)):
        return {node.name}
    if isinstance(node, ast.Assign):
        return {n.id for t in node.targets for n in ast.walk(t)
                if isinstance(n, ast.Name)}
    if isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
        return {node.target.id}
    return set()


def _public_names(path: pathlib.Path) -> set[str]:
    """A JAX module's public names: its ``__all__``, else what it defines
    (and, in a package's ``__init__``, what it imports from the package)
    without a leading underscore."""
    tree = ast.parse(path.read_text())
    declared = _all(tree)
    if declared is not None:
        return declared
    names = set()
    for node in _top_level(tree):
        names |= _bound(node)
        if (path.name == "__init__.py" and isinstance(node, ast.ImportFrom)
                and node.level):
            names |= {a.asname or a.name for a in node.names}
    return {n for n in names if not n.startswith("_")}


def _present_names(path: pathlib.Path) -> set[str]:
    """Every name a port module binds at top level, imported names and
    its ``__all__`` (names it loads lazily) included."""
    tree = ast.parse(path.read_text())
    names = set(_all(tree) or ())
    for node in _top_level(tree):
        names |= _bound(node)
        if isinstance(node, ast.Import):
            names |= {(a.asname or a.name).split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names |= {a.asname or a.name for a in node.names}
    return names


def test_public_names_have_counterparts():
    """Every public name of every ``lzs_tpu`` module (read by AST, no jax
    import) is present in the port's module of the same path, apart from
    NOT_PORTED: the port does everything the JAX package does."""
    missing = {}
    for src in sorted((REPO / "lzs_tpu").rglob("*.py")):
        rel = src.relative_to(REPO / "lzs_tpu").as_posix()
        port = REPO / "lzs_tpu_torch" / rel
        have = _present_names(port) if port.exists() else set()
        gone = _public_names(src) - have - NOT_PORTED.get(rel, set())
        if gone:
            missing[rel] = sorted(gone)
    assert missing == {}
    for rel, names in NOT_PORTED.items():
        assert names <= _public_names(REPO / "lzs_tpu" / rel), rel


def test_spec_constants_equal_jax_package():
    public = [k for k in dir(jspec) if k.isupper() and k != "DEFAULT_CONFIG"]
    assert len(public) > 10
    for k in public:
        assert getattr(tspec, k) == getattr(jspec, k), k
    assert (dataclasses.asdict(tspec.DEFAULT_CONFIG)
            == dataclasses.asdict(jspec.DEFAULT_CONFIG))
    for n in (0, 1, 7, 8, 2048, 32768):
        assert tspec.compressed_max(n) == jspec.compressed_max(n)
        assert tspec.decompressed_max(n) == jspec.decompressed_max(n)
    for off in (1, 127, 128, 2047):
        for length in (2, 7, 8, 22, 23, 300):
            assert tspec.match_bits(off, length) == jspec.match_bits(
                off, length)
