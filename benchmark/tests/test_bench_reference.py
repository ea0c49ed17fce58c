"""The references against the program's plain paths at a tiny size: the
integer engines (``kernels=()``, and the default kernels, whose wrappers
run their plain versions on the CPU) and the QAT train step."""

import ast
import pathlib

import pytest
import torch

from benchmark import training
from benchmark.reference import swin, vit
from benchmark.reference.weights import generator
from benchmark.tests.tiny import TINY_MODELS, tiny_cell
from benchmark.trace import Spans

REFERENCE = pathlib.Path(__file__).resolve().parents[1] / "reference"


def _artifact(family, model, seed):
    g = generator(seed, "cpu")
    img = model["img_size"]
    return family.calibrate(model, family.make_params(model, g, "cpu"), torch.randn((2, img, img, 3), generator=g))


@pytest.mark.parametrize("softmax_bits, gelu_stable", [(8, True), (16, False), (8, False)])
@pytest.mark.parametrize("kernels", [(), ("attention", "layernorm")])
def test_vit_reference_equals_engine(softmax_bits, gelu_stable, kernels):
    from ivit_tpu_torch.deploy.engine import build_vit_infer

    model = dict(TINY_MODELS["vit"], mlp_ratio=4.0, softmax_bits=softmax_bits, gelu_stable=gelu_stable)
    a = _artifact(vit, model, 2**31 + 3)
    images = torch.randn((5, 32, 32, 3), generator=torch.Generator().manual_seed(1))
    ref = vit.forward(vit.carry(a, "cpu"), images)
    assert torch.equal(build_vit_infer(a, "cpu", kernels=kernels)(images), ref)
    assert ref.abs().max() > 0


@pytest.mark.parametrize("gelu_stable", [False, True])
def test_swin_reference_equals_engine(gelu_stable):
    from ivit_tpu_torch.deploy.swin_engine import build_swin_infer

    model = dict(TINY_MODELS["swin"], mlp_ratio=4.0, gelu_stable=gelu_stable)
    model["depths"], model["num_heads"] = tuple(model["depths"]), tuple(model["num_heads"])
    a = _artifact(swin, model, 7)
    images = torch.randn((3, 32, 32, 3), generator=torch.Generator().manual_seed(2))
    ref = swin.forward(swin.carry(a, "cpu"), images)
    for kernels in ((), ("attention", "layernorm")):
        assert torch.equal(build_swin_infer(a, "cpu", kernels=kernels)(images), ref)


def test_int4_control_moves_the_logits():
    model = dict(TINY_MODELS["vit"], mlp_ratio=4.0, softmax_bits=8, gelu_stable=True)
    t = vit.carry(_artifact(vit, model, 5), "cpu")
    images = torch.randn((4, 32, 32, 3), generator=torch.Generator().manual_seed(3))
    ref, low = vit.forward(t, images), vit.forward(t, images, weight_bits=4)
    assert ((ref - low).abs().amax(1) / ref.abs().amax(1)).max() > 0.05


def test_qat_reference_equals_train_step():
    cell = tiny_cell("deit_s.train_b128")
    job = training.Job(cell, 2**31 + 5, "cpu")
    state = training.checked_steps(training.Program(job), 3, Spans(False))
    got = training.compare(state, training.run_reference(job, 3), job.weights)
    assert got == {"loss_gap": 0.0, "grad_gap": 0.0, "change_gap": 0.0}


def test_reference_imports_nothing_of_the_program():
    for path in REFERENCE.glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                names = [a.name for a in node.names] if isinstance(node, ast.Import) else [node.module or ""]
                assert not any(n.split(".")[0] in {"ivit_tpu_torch", "ivit_tpu", "jax", "flax"} for n in names), path
