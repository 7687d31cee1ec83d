"""No module of the benchmark imports JAX or the JAX package (top-level
names compared whole: pygpa_tpu_torch is not pygpa_tpu), and the
reference imports nothing of the program."""
import ast
import os
import sys

import pytest

GPABENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(GPABENCH))

from gpabench.harness import main as hm  # noqa: E402

FORBIDDEN = {"jax", "jaxlib", "flax", "pygpa_tpu"}


def sources(sub=""):
    out = []
    for d, _, files in os.walk(os.path.join(GPABENCH, sub)):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def imported_tops(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


@pytest.mark.parametrize("path", sources(), ids=lambda p: os.path.relpath(
    p, GPABENCH))
def test_no_jax_or_jax_package(path):
    assert not imported_tops(path) & FORBIDDEN


@pytest.mark.parametrize("path", sources("reference"),
                         ids=lambda p: os.path.relpath(p, GPABENCH))
def test_reference_imports_nothing_of_the_program(path):
    tops = imported_tops(path)
    assert tops <= {"math", "itertools", "numpy", "torch"}, tops


def test_loaded_modules_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "pygpa_tpu_torch_probe", sys)
    assert hm.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "pygpa_tpu", sys)
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert hm.forbidden_modules() == ["jax", "pygpa_tpu"]
