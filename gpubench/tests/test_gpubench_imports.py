"""What the benchmark may import: never JAX or the JAX package (their
top-level names compared whole: the program's name begins with the JAX
package's), and, in the reference, nothing of the program."""

import ast
import importlib
import sys
from pathlib import Path

import pytest

from gpubench import result

from .helpers import run_grid_cpu

BENCH = Path(__file__).resolve().parents[1]
JAX = {"jax", "jaxlib", "flax", "ldpcsimulation_tpu"}
PROGRAM = "ldpcsimulation_tpu_torch"


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(BENCH)) for p in SOURCES])
def test_no_jax(path):
    assert not top_level_imports(path) & JAX


@pytest.mark.parametrize(
    "path", sorted((BENCH / "reference").glob("*.py")),
    ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert PROGRAM not in top_level_imports(path)
    assert top_level_imports(path) <= {"__future__", "dataclasses", "json",
                                       "math", "pathlib", "numpy", "torch"}


def test_guard_compares_whole_names(monkeypatch):
    for name in list(sys.modules):
        if name.split(".")[0] in JAX:
            monkeypatch.delitem(sys.modules, name)
    importlib.import_module(PROGRAM)
    monkeypatch.setitem(sys.modules, "ldpcsimulation_tpu_torch_like", sys)
    assert result.jax_loaded() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert result.jax_loaded() == ["jax"]
    monkeypatch.setitem(sys.modules, "ldpcsimulation_tpu.codes", sys)
    assert result.jax_loaded() == ["jax", "ldpcsimulation_tpu"]


def test_emit_refuses_with_jax_loaded(monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "jax", sys)
    assert result.emit({"correct": True}, {}, 1) == 1
    assert capsys.readouterr().out == ""


def test_grid_refuses_with_jax_loaded_on_another_rank():
    out = run_grid_cpu("jax_on_rank_1")
    assert out.returncode == 1
    assert out.stdout.strip() == ""
    assert "jax loaded in rank 1" in out.stderr
