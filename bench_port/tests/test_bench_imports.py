"""Nothing under bench_port/ imports JAX or the JAX package; the reference
imports nothing of the port either.  Top-level names are compared whole:
``iterative_cleaner_tpu_torch`` is not ``iterative_cleaner_tpu``."""

import ast
import sys
from pathlib import Path

import pytest

from bench_port import harness

BENCH = Path(__file__).resolve().parents[1]
FILES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


def top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".", 1)[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".", 1)[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".", 1)[0])
    return names


def test_every_file_is_scanned():
    assert BENCH / "run.py" in FILES and BENCH / "reference" / "clean.py" in FILES


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_or_jax_package(path):
    assert not top_level_imports(path) & set(harness.FORBIDDEN)


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert top_level_imports(path) <= {"__future__", "numpy", "torch"}


def test_whole_names_are_compared(monkeypatch):
    monkeypatch.setitem(sys.modules, "iterative_cleaner_tpu_torch_probe", sys)
    assert "iterative_cleaner_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax" in harness.forbidden_modules()


def test_scan_finds_a_planted_import(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import iterative_cleaner_tpu.ops\nfrom jax import numpy\n"
                   "import iterative_cleaner_tpu_torch\n")
    assert top_level_imports(bad) & set(harness.FORBIDDEN) == {"iterative_cleaner_tpu", "jax"}
