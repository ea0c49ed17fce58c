"""The PyTorch port stands alone: no JAX, flax, optax or ivit_tpu import
anywhere in ``ivit_tpu_torch/`` (the machine with the GPU has no JAX)."""

import ast
import os

import pytest

_PKG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "ivit_tpu_torch")
_FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ivit_tpu")


def _py_files():
    for root, _, files in os.walk(_PKG):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.relpath(os.path.join(root, f), _PKG)


def _imported_roots(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_package_has_modules():
    files = set(_py_files())
    for f in ("deploy/engine.py", "kernels/attention_fused.py", "kernels/intnorm_fused.py"):
        assert f in files


@pytest.mark.parametrize("relpath", sorted(_py_files()))
def test_no_jax_imports(relpath):
    roots = set(_imported_roots(os.path.join(_PKG, relpath)))
    assert not roots & set(_FORBIDDEN), f"{relpath} imports {sorted(roots & set(_FORBIDDEN))}"
