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
    for f in ("deploy/engine.py", "kernels/attention_fused.py", "kernels/intnorm_fused.py",
              "kernels/attention_fused_v2.py", "kernels/linear_gelu_fused.py",
              "kernels/shiftgelu_fused.py", "kernels/shiftmax_fused.py", "kernels/_gelu_common.py",
              "kernels/window_attention_fused.py", "models/swin.py", "deploy/swin_artifact.py",
              "deploy/swin_engine.py", "deploy/swin_synthetic.py", "core/dyadic.py", "deploy/graphs.py",
              "deploy/ingest_torch.py", "convert_model.py", "evaluate_latency.py", "bench.py"):
        assert f in files


@pytest.mark.parametrize("relpath", sorted(_py_files()))
def test_no_jax_imports(relpath):
    roots = set(_imported_roots(os.path.join(_PKG, relpath)))
    assert not roots & set(_FORBIDDEN), f"{relpath} imports {sorted(roots & set(_FORBIDDEN))}"


_REPO = os.path.dirname(_PKG)


@pytest.mark.parametrize("relpath", ["chip_smoke.py", "scripts/torch_engine_turns.py"])
def test_card_scripts_import_no_jax(relpath):
    """The scripts that run on the card's machine import no JAX either."""
    roots = set(_imported_roots(os.path.join(_REPO, relpath)))
    assert not roots & set(_FORBIDDEN), f"{relpath} imports {sorted(roots & set(_FORBIDDEN))}"


@pytest.mark.parametrize("root", [_REPO, os.path.join(_REPO, "no_such_checkout")], ids=["checkout", "missing"])
def test_engine_turns_refuses_without_card(root):
    """scripts/torch_engine_turns.py prints no result and exits nonzero
    without a CUDA device, or for a directory without the package."""
    import subprocess
    import sys

    import torch

    if torch.cuda.is_available() and root == _REPO:
        pytest.skip("a CUDA device is present: the script would time the engines")
    run = subprocess.run([sys.executable, os.path.join(_REPO, "scripts", "torch_engine_turns.py"), root],
                         capture_output=True, text=True, timeout=120)
    assert run.returncode != 0 and run.stdout == ""
