"""No module of the benchmark imports JAX or the JAX package, and the plain
reference imports nothing of the program: top-level module names compared
whole (``islam_tpu_torch`` begins with ``islam_tpu``)."""

import ast

import pytest

from pb_helpers import ROOT

BENCH = ROOT / "portbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "islam_tpu"}


def imported(path):
    """The top-level names of every module ``path`` imports."""
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args and isinstance(
                        node.args[0], ast.Constant):
            out.add(str(node.args[0].value).split(".")[0])
    return out


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not imported(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "ref").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    names = imported(path)
    assert "islam_tpu_torch" not in names
    assert names <= {"__future__", "datetime", "os", "dataclasses", "typing",
                     "numpy", "scipy", "torch", "portbench", "struct",
                     "zlib"}, names


def test_whole_name_compare():
    # islam_tpu_torch is the program, not the JAX package
    assert "islam_tpu_torch".split(".")[0] not in FORBIDDEN
    assert "islam_tpu.train".split(".")[0] in FORBIDDEN
