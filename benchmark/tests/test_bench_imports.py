"""Nothing that a run loads is JAX or the JAX package, compared by whole
top-level names (the port's name begins with the JAX package's), and the
reference imports nothing of the program."""

import ast
import sys

import pytest

from benchmark.run import FORBIDDEN, forbidden_modules
from benchmark.spec import REPO

BENCH = REPO / "benchmark"


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", "") == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def _sources(folder):
    return [p for p in folder.rglob("*.py") if "tests" not in p.relative_to(BENCH).parts]


@pytest.mark.parametrize("path", _sources(BENCH), ids=lambda p: str(p.relative_to(BENCH)))
def test_no_module_imports_jax_or_the_jax_package(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & set(FORBIDDEN), tops & set(FORBIDDEN)


@pytest.mark.parametrize("path", _sources(BENCH / "reference"),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_the_reference_imports_nothing_of_the_program(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert "gasfm_tpu_torch" not in tops and not tops & set(FORBIDDEN)


def test_only_the_program_adapter_imports_the_program():
    users = [p.relative_to(BENCH).as_posix() for p in _sources(BENCH)
             if "gasfm_tpu_torch" in {n.split(".")[0] for n in _imports(p)}]
    assert users == ["program.py"]


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    before = forbidden_modules()
    monkeypatch.setitem(sys.modules, "gasfm_tpu_torch.fake", sys)
    monkeypatch.setitem(sys.modules, "jaxfake", sys)
    assert forbidden_modules() == before
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys)
    assert "jaxlib" in forbidden_modules()
