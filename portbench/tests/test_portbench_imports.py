"""Nothing under portbench/ imports JAX, the JAX package ``repro`` or
``benchmarks/`` (top-level names compared whole: ``repro_torch`` is not
``repro``), and the reference imports nothing of the program."""
from __future__ import annotations

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def top_level_imports(path: Path) -> set:
    tree = ast.parse(path.read_text(), filename=str(path))
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


FILES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_no_reference_package(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "repro_torch" not in top_level_imports(path)


def test_only_the_adapter_imports_the_program():
    users = {p.relative_to(BENCH).as_posix() for p in FILES
             if "repro_torch" in top_level_imports(p)
             and "tests" not in p.parts}
    assert users == {"harness/program.py"}


def test_whole_names_are_compared(monkeypatch):
    import sys
    import types
    from portbench import run
    monkeypatch.setitem(sys.modules, "repro_torch.probe",
                        types.ModuleType("repro_torch.probe"))
    monkeypatch.setitem(sys.modules, "repro.probe",
                        types.ModuleType("repro.probe"))
    found = run.forbidden_modules()
    assert "repro.probe" in found and "repro_torch.probe" not in found
