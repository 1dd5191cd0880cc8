"""Nothing of the benchmark imports JAX or the JAX package, and the reference
imports nothing of the program: top-level module names compared whole (the
port's name begins with the JAX package's)."""
import ast
import os

import pytest

from portbench import harness

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def sources(sub=""):
    base = os.path.join(HERE, sub)
    for d, _, files in os.walk(base):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def top_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", sorted(sources()), ids=lambda p: os.path.relpath(p, HERE))
def test_no_jax(path):
    assert not top_imports(path) & {"jax", "jaxlib", "flax", "mi_optimize_tpu"}


@pytest.mark.parametrize("path", sorted(sources("reference")), ids=os.path.basename)
def test_reference_imports_nothing_of_the_program(path):
    assert "mi_optimize_tpu_torch" not in top_imports(path)
    with open(path) as f:
        assert "mi_optimize_tpu" not in f.read()


def test_forbidden_modules_compares_whole_names():
    mods = {"mi_optimize_tpu_torch": 1, "mi_optimize_tpu_torch.ops": 1, "jaxtyping": 1,
            "numpy": 1}
    assert harness.forbidden_modules(mods) == []
    mods.update({"mi_optimize_tpu.models": 1, "jax": 1})
    assert harness.forbidden_modules(mods) == ["jax", "mi_optimize_tpu.models"]
