"""The ``vit_long`` family (``reference/vit_long.py``) at a tiny model over
256 tokens on the CPU: equal to the program's engine bit for bit on its
plain path and on its kernels (whose wrappers run their plain versions
here: K10 at these rows), moved by the int4 control, and importing
nothing of the program. Also the new cell's work counts and metrics."""

import ast
import pathlib

import numpy as np
import pytest
import torch

from benchmark import control, peaks, spec
from benchmark.reference import vit_long
from benchmark.reference.weights import generator
from benchmark.tests.tiny import tiny_cell
from benchmark.trace import TraceView

# img 68, patch 4: 17 x 17 patches and the class token, 290 tokens
LONG = dict(img_size=68, patch_size=4, embed_dim=32, depth=2, num_heads=2, num_classes=10, mlp_ratio=4.0,
            softmax_bits=8, gelu_stable=True)
VIT_L384 = dict(img_size=384, patch_size=16, embed_dim=1024, depth=24, num_heads=16, mlp_ratio=4.0,
                num_classes=1000)


def _artifact(model, seed):
    g = generator(seed, "cpu")
    img = model["img_size"]
    params = vit_long.make_params(model, g, "cpu")
    return vit_long.calibrate(model, params, torch.randn((2, img, img, 3), generator=g))


@pytest.fixture(scope="module")
def long_model():
    a = _artifact(LONG, 2**31 + 41)
    images = torch.randn((3, 68, 68, 3), generator=torch.Generator().manual_seed(4))
    return a, images, vit_long.forward(vit_long.carry(a, "cpu"), images)


@pytest.mark.parametrize("kernels", [(), ("attention", "layernorm")], ids=["plain", "defaults"])
def test_vit_long_reference_equals_engine(long_model, kernels):
    from ivit_tpu_torch.deploy.engine import build_vit_infer

    a, images, ref = long_model
    assert torch.equal(build_vit_infer(a, "cpu", kernels=kernels)(images), ref)
    assert ref.abs().max() > 0


def test_int4_control_moves_the_logits(long_model):
    a, images, ref = long_model
    low = vit_long.forward(vit_long.carry(a, "cpu"), images, weight_bits=4)
    assert ((ref - low).abs().amax(1) / ref.abs().amax(1)).max() > 0.05


def test_tree_row_sum_over_256_and_two_limbs_up_to_it():
    e = torch.full((2, 300), 2.0**24 + 2.0**13)  # limbs 1, 2, 0
    e[1, :] = 3.0
    e[1, 0] = 2.0**31  # the clip's side: limbs 128, 0, 0
    f = np.float32
    want = [(f(300) * f(4096) + f(600)) * f(4096) + f(0), (f(128) * f(4096) + f(0)) * f(4096) + f(299 * 3)]
    assert vit_long.tree_row_sum(e).flatten().tolist() == [float(w) for w in want]
    with pytest.raises(ValueError, match="4096"):
        vit_long.tree_row_sum(torch.zeros((1, 4097)))
    q = torch.randint(-128, 128, (4, 200)).to(torch.float32)
    scale = torch.tensor(1 / 40.0)
    assert torch.equal(vit_long.shiftmax(q, scale), vit_long.ops.shiftmax(q, scale))


def test_vit_long_imports_nothing_of_the_program():
    for name in ("reference/vit_long.py", "work/vit_long.py", "work/K10.py"):
        tree = ast.parse((pathlib.Path(spec.ROOT) / "benchmark" / name).read_text())
        for node in ast.walk(tree):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                names = [x.name for x in node.names] if isinstance(node, ast.Import) else [node.module or ""]
                assert not any(n.split(".")[0] in {"ivit_tpu_torch", "ivit_tpu", "jax", "flax"} for n in names), name


def test_new_cell_is_found_and_its_control_fails_the_limit():
    cell = spec.load("vit_l384.serve_b128")
    assert cell.config["family"] == "vit_long" and cell.model["img_size"] == 384 and cell.chips == 1
    names = [m["name"] for m in cell.per_layer]
    assert {"K10_roofline", "attention_core_ms.serve", "K3_roofline", "mfu.serve"} <= set(names)
    assert "K1_roofline" not in names
    assert [m["name"] for m in cell.end_to_end] == ["images_per_s", "setup_s"]
    cell.config["model"].update(LONG)
    cell.traffic.update(batch=4, pool=2, warmup=1, trace_units=2)
    limit = cell.config["checks"]["serve"]["logit_gap"]
    got = control.serving(cell, 2**31 + 43, torch.device("cpu"))
    assert got["program"]["logit_gap"] <= limit < got["control_int4"]["logit_gap"]


def test_k10_bytes_operations_and_roofline():
    work = spec.load_module("work", "K10")
    launches = work.launches(VIT_L384, 128)
    assert len(launches) == 24
    assert launches[0] == (4 * 2048 * 577 * 64, 4 * 2048 * 577 * 577 * 64) == (302_514_176, 174_550_679_552)
    assert launches[0][0] / peaks.HBM_BYTES * 1e3 == pytest.approx(0.0903, abs=5e-5)
    assert spec.load_module("work", "vit_long").forward_ops(dict(VIT_L384, mlp_ratio=4.0)) == 382_132_600_832
    assert work.NAME.search("void ivit::attn_long::attention_long_kernel<false, 2>(signed char const*)")
    assert not work.NAME.search("void ivit::attn_mma::attention_mma_kernel<false, false, 2>(signed char const*)")
    cell = spec.load("vit_l384.serve_b128")
    bound = sum(max(b / peaks.HBM_BYTES, o / peaks.INT8_OPS) for b, o in launches)
    view = TraceView(window_s=1.0, busy_s=0.9, device_ops=[("attention_long_kernel<false, 2>", 4 * bound, "kernel")],
                     kernel_launches=24, units=2, images=256, cell=cell, breakdown={})
    assert spec.load_module("metrics", "K10_roofline").read(view) == pytest.approx(50.0)
    view.device_ops = [("attention_mma_kernel<false, false, 2>", 1.0, "kernel")]
    assert spec.load_module("metrics", "K10_roofline").read(view) is None


def test_attention_core_reader(monkeypatch):
    from ivit_tpu_torch.utils import spans

    monkeypatch.setattr(spans, "_samples", [])
    monkeypatch.setattr(spans, "_replayed", [])
    read = spec.load_module("metrics", "attention_core_ms.serve").read
    assert read(None) is None
    spans._samples += [(("engine.attention", 3.0), ("engine.attention_core", 1.0), ("engine.mlp", 2.0),
                        ("engine.attention", 3.0), ("engine.attention_core", 1.5)),
                       (("engine.attention", 3.0), ("engine.attention_core", 2.0), ("engine.mlp", 2.0),
                        ("engine.attention", 3.0), ("engine.attention_core", 2.5))]
    assert read(None) == pytest.approx((2.5 + 4.5) / 2)
    assert spec.load_module("metrics", "attention_ms.serve").read(None) == pytest.approx(6.0)


def test_sound_tiny_run_is_correct():
    from benchmark.tests.tiny import execute

    cell = tiny_cell("deit_s.serve_b128")
    long_cell = spec.load("vit_l384.serve_b128")
    long_cell.config["model"].update(LONG)
    long_cell.traffic.update(batch=cell.traffic["batch"], pool=2, warmup=1, trace_units=2)
    r = execute(long_cell, trace=True)
    assert r["correct"] is True and r["checks"]["logit_gap"]["value"] == 0.0
