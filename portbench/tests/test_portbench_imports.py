"""No module of the benchmark imports JAX or the JAX package ``repro``,
and the reference imports nothing of the program either. Top-level names
are compared whole: ``repro_torch`` begins with ``repro``."""

import ast

import pytest

from portbench.tests.smoke import ROOT

BENCH = ROOT / "portbench"
JAX_SIDE = {"jax", "jaxlib", "flax", "repro"}


def top_names(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant) and \
                isinstance(node.args[0].value, str):
            yield node.args[0].value.split(".")[0]


MODULES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_module_imports_the_jax_side(path):
    assert not set(top_names(path)) & JAX_SIDE


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    assert not set(top_names(path)) & (JAX_SIDE | {"repro_torch"})


def test_the_names_are_compared_whole():
    assert "repro" not in {"repro_torch"}
    assert set(top_names(BENCH / "harness.py")) >= {"repro_torch"}
