"""No file the harness runs imports JAX or the JAX package, the
reference imports nothing of the program either, and nothing reads the
JAX package's benchmarks."""
from __future__ import annotations

import ast
import sys

import pytest

from perfbench.tests._cells import ROOT, harness

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
HARNESS = sorted(p for p in (ROOT / "perfbench").rglob("*.py")
                 if "tests" not in p.relative_to(ROOT / "perfbench").parts)
REFERENCE = sorted((ROOT / "perfbench" / "reference").glob("*.py"))


def top_level_imports(path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".", 1)[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".", 1)[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(
                node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".", 1)[0])
    return names


@pytest.mark.parametrize("path", HARNESS, ids=lambda p: p.name)
def test_perfbench_harness_imports_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN
    assert "benchmarks/" not in path.read_text()


@pytest.mark.parametrize("path", REFERENCE, ids=lambda p: p.name)
def test_perfbench_reference_imports_nothing_of_the_program(path):
    assert not top_level_imports(path) & (FORBIDDEN | {"repro_torch"})


def test_perfbench_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_like", sys)
    assert "repro" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert "repro" in harness.forbidden_modules()
    assert set(harness.FORBIDDEN) == FORBIDDEN
