"""What the benchmark imports: no module under ``bench/`` imports ``jax``,
``jaxlib``, ``flax`` or the JAX package ``repro`` (top-level names compared
whole: ``repro_torch`` is the port, not ``repro``), none reads the old
``benchmarks`` folder, and the plain reference imports nothing of the
program."""
from __future__ import annotations

import ast

import pytest

import bench_smoke

BENCH = bench_smoke.ROOT / "bench"
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
FILES = sorted(BENCH.rglob("*.py"))
#: the JAX-era benchmark folder, as a path would name it
OLD = "benchmarks" + "/"


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not set(_imports(path)) & FORBIDDEN
    assert OLD not in path.read_text()


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    names = set(_imports(path))
    assert names <= {"__future__", "typing", "torch", "numpy", "math"}, names


def test_the_guard_compares_whole_names(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import repro_torch.runtime\nfrom repro.model import lm\n")
    assert set(_imports(f)) == {"repro_torch", "repro"}


def test_the_runtime_guard_compares_whole_names(monkeypatch):
    import sys
    import types

    from bench import run as bench_run

    for name in ("repro_torch_extra", "jaxonomy"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert not {"repro_torch_extra", "jaxonomy"} & set(
        bench_run.forbidden_loaded())
    monkeypatch.setitem(sys.modules, "repro.fake", types.ModuleType("x"))
    assert "repro.fake" in bench_run.forbidden_loaded()
