"""The PyTorch port stands alone: no JAX, flax, optax or ivit_tpu import
anywhere in ``ivit_tpu_torch/`` (the machine with the GPU has no JAX),
and no Pillow import when a module is imported (only ``data/pil_ops.py``,
which the transforms import at their first RandAugment or colour-jitter
call, needs it)."""

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
              "deploy/ingest_torch.py", "convert_model.py", "evaluate_latency.py", "bench.py",
              "core/ste.py", "core/qtensor.py", "core/scalars.py", "core/device.py", "ops/intmm.py", "nn/quant.py",
              "nn/vit_blocks.py", "nn/flax_state.py", "models/vit.py", "models/model_utils.py",
              "deploy/convert.py", "train/losses.py", "train/schedule.py", "train/state.py", "train/steps.py",
              "train/augment.py", "utils/checkpoint.py", "utils/metrics.py", "data/datasets.py",
              "data/transforms.py", "data/loader.py", "data/pil_ops.py", "quant_train.py", "evaluate_accuracy.py",
              "models/vit_float.py", "models/swin_float.py", "models/import_torch.py", "models/import_swin.py",
              "nn/remat.py", "deploy/export.py", "parallel/mesh.py", "parallel/tp_infer.py", "parallel/data.py",
              "parallel/tensor.py"):
        assert f in files


def test_models_import_no_deploy_module():
    """The model layer sits below the deploy layer: ``models/`` imports
    nothing from ``deploy/`` (the Swin pool, ``token_mean``, lives in
    ``models/swin.py`` and the engine imports it from there)."""
    for f in sorted(_py_files()):
        if not f.startswith("models/"):
            continue
        tree = ast.parse(open(os.path.join(_PKG, f)).read(), filename=f)
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom):
                module = node.module or ""
                assert not (node.level >= 2 and module.startswith("deploy")), f"{f} imports ..{module}"
                assert not module.startswith("ivit_tpu_torch.deploy"), f"{f} imports {module}"


@pytest.mark.parametrize("relpath", sorted(_py_files()))
def test_no_jax_imports(relpath):
    roots = set(_imported_roots(os.path.join(_PKG, relpath)))
    assert not roots & set(_FORBIDDEN), f"{relpath} imports {sorted(roots & set(_FORBIDDEN))}"


_REPO = os.path.dirname(_PKG)
_PILLOW_MODULES = ("data/pil_ops.py",)


def test_modules_import_without_pillow():
    """Every module but ``data/pil_ops.py`` imports with Pillow unimportable."""
    import subprocess
    import sys

    modules = [f"ivit_tpu_torch.{f[:-3].replace('/', '.')}".removesuffix(".__init__") for f in _py_files()
               if f not in _PILLOW_MODULES]
    code = ("import importlib, sys\nsys.modules['PIL'] = None\n"
            f"sys.path.insert(0, {_REPO!r})\n"
            f"for m in {modules!r}:\n    importlib.import_module(m)\nprint(len({modules!r}))")
    run = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr
    assert int(run.stdout) == len(modules) > 60


@pytest.mark.parametrize("relpath", ["chip_smoke.py", "scripts/torch_engine_turns.py",
                                     "scripts/torch_int_mm_domain.py", "scripts/torch_train_memory.py",
                                     "scripts/torch_reload_engine.py", "scripts/torch_repeat_qat_forward.py"])
def test_card_scripts_import_no_jax(relpath):
    """The scripts that run on the card's machine import no JAX either."""
    roots = set(_imported_roots(os.path.join(_REPO, relpath)))
    assert not roots & set(_FORBIDDEN), f"{relpath} imports {sorted(roots & set(_FORBIDDEN))}"


def test_rank_worker_imports_no_jax():
    """The ranks the multi-process tests spawn import neither JAX nor a
    test file (``tests/torch_parallel_worker.py``), so each starts in
    seconds."""
    roots = set(_imported_roots(os.path.join(_REPO, "tests", "torch_parallel_worker.py")))
    assert not roots & set(_FORBIDDEN), sorted(roots & set(_FORBIDDEN))
    assert not {r for r in roots if r.startswith("test_")}


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
