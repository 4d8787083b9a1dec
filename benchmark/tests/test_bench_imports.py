"""What the benchmark imports, by top-level module name compared whole (the
port's name begins with the JAX package's): nothing under benchmark/
imports JAX, flax or the JAX package, and the reference, with the data
kinds' readers, imports nothing of the port."""

import ast
import os

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "cutmix_seg_tpu"}


def _top_names(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            arg = node.args[0] if node.args else None
            if isinstance(arg, ast.JoinedStr) and isinstance(arg.values[0], ast.Constant):
                yield arg.values[0].value.split(".")[0]
            elif isinstance(arg, ast.Constant):
                yield str(arg.value).split(".")[0]


def _files(sub=""):
    for root, _, names in os.walk(os.path.join(HERE, sub)):
        for n in names:
            if n.endswith(".py"):
                yield os.path.join(root, n)


@pytest.mark.parametrize("path", sorted(_files()), ids=lambda p: os.path.relpath(p, HERE))
def test_no_jax_anywhere(path):
    assert not set(_top_names(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted([*_files("reference"), *_files("kinds")]),
                         ids=lambda p: os.path.relpath(p, HERE))
def test_reference_imports_nothing_of_the_port(path):
    assert "cutmix_seg_tpu_torch" not in set(_top_names(path))


def test_the_check_compares_whole_names(monkeypatch):
    import sys
    import types

    from benchmark.run import forbidden_loaded

    monkeypatch.setitem(sys.modules, "cutmix_seg_tpu_torch_fake.sub", types.ModuleType("x"))
    assert "cutmix_seg_tpu" not in forbidden_loaded()
    monkeypatch.setitem(sys.modules, "cutmix_seg_tpu.fake", types.ModuleType("y"))
    assert "cutmix_seg_tpu" in forbidden_loaded()
