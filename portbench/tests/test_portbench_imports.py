"""What the benchmark may import: never JAX or the JAX package, and the
reference nothing of the program. Names are compared whole, by their
top-level part: ``lzs_tpu_torch`` is not ``lzs_tpu``."""

from __future__ import annotations

import ast
import sys
import types

import pytest

from portbench import run
from small import ROOT

PKG = ROOT / "portbench"
SOURCES = sorted(PKG.rglob("*.py"))
FORBIDDEN = {"jax", "jaxlib", "flax", "lzs_tpu", "bench"}


def _imports(path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(
    p.relative_to(PKG)))
def test_no_jax_import(path):
    assert not _imports(path) & FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    for path in (PKG / "reference").rglob("*.py"):
        assert "lzs_tpu_torch" not in _imports(path)
        assert not _imports(path) - {"__future__", "struct"}


def test_forbidden_names_are_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "lzs_tpu_torch_extra",
                        types.ModuleType("lzs_tpu_torch_extra"))
    assert run.forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, "lzs_tpu.spec",
                        types.ModuleType("lzs_tpu.spec"))
    assert run.forbidden_loaded() == ["lzs_tpu"]


def test_a_run_loads_no_jax():
    import subprocess

    code = ("import sys, json; from portbench import run; "
            "from small import BENCH, SEED, SMALL; "
            "run.run_cell(BENCH, 'ipcomp-1500.raw-decode', SEED, 0.5, False,"
            " device='cpu', traffic=SMALL['ipcomp-1500.raw-decode']); "
            "print(json.dumps(run.forbidden_loaded()))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, text=True,
                         capture_output=True, timeout=300,
                         env={"PYTHONPATH": f"{ROOT}:{PKG / 'tests'}",
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
