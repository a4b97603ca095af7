"""What the benchmark may import: nothing of JAX or the JAX package
anywhere, nothing of the program in the reference nor in a family's
weights, reference or product count, and the program only through a
family's ``system.py`` (the tests drive it too)."""

import ast
import sys
from pathlib import Path

import pytest

from portbench import run

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "vault_tpu"}


def top_level_imports(path: Path) -> set:
    """The top-level names of every module a file imports, whole."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(HERE.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_nor_the_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


PLAIN = sorted([*(HERE / "reference").rglob("*.py"),
                *(p for part in ("reference", "weights", "flops")
                  for p in (HERE / "families").glob(f"*/{part}.py"))])


@pytest.mark.parametrize("path", PLAIN, ids=lambda p: p.name if p.parent == HERE / "reference"
                         else p.relative_to(HERE).as_posix())
def test_reference_imports_nothing_of_the_program(path):
    assert "vault_tpu_torch" not in top_level_imports(path)
    assert top_level_imports(path) <= {"__future__", "math", "typing", "numpy", "torch",
                                       "portbench"}


def test_only_the_system_module_imports_the_program():
    users = {p.relative_to(HERE).as_posix() for p in SOURCES
             if "vault_tpu_torch" in top_level_imports(p) and "tests" not in p.parts}
    systems = {p.relative_to(HERE).as_posix() for p in (HERE / "families").glob("*/system.py")}
    assert "families/vault_bert/system.py" in users and users <= systems


def test_whole_names_are_compared(monkeypatch):
    monkeypatch.setitem(sys.modules, "vault_tpu_torch_probe", sys)
    assert "vault_tpu_torch_probe" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "vault_tpu.sub", sys)
    assert run.forbidden_modules() == ["vault_tpu"]
