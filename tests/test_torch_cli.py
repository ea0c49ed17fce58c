"""The port's serving entry points on the CPU: ``convert_model``,
``evaluate_latency``, ``bench`` and ``deploy.graphs``.

* ``python -m ivit_tpu_torch.convert_model --torch-checkpoint``: a
  reference-style state dict saved with ``torch.save`` comes back as the
  artifact JAX's ingester makes from it (tolerance 0); ``--checkpoint``
  and ``--export-engine`` exit with their messages.
* ``evaluate_latency --device cpu`` prints the JAX CLI's line at a tiny
  size, for ViT and Swin.
* ``bench._float_vit_infer`` agrees with the root ``bench.py``'s
  ``_float_vit_infer`` (imported as it is) within a float32 tolerance;
  ``bench.main --device cpu`` prints one JSON line with ``bench.py``'s
  keys.
* ``capture_infer`` raises on the CPU; the scalars a forward reads are
  carried as tensors, so a forward builds none from Python numbers.
"""

import importlib
import json
import pickle
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ivit_tpu.deploy import ingest_torch as jax_ingest
from ivit_tpu_torch import bench, convert_model, evaluate_latency
from ivit_tpu_torch.deploy import build_swin_infer, build_vit_infer, synthetic_swin_artifact, synthetic_vit_artifact
from ivit_tpu_torch.deploy.graphs import capture_infer
from ivit_tpu_torch.deploy.swin_engine import token_mean
from ivit_tpu_torch.ops.interp import f32
from tests.test_torch_ingest import SWIN_TINY, assert_same, reference_swin_state, reference_vit_state

# bench.py's JSON keys (bench.py:213-222)
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline"}
LATENCY_LINE = re.compile(r"^(\S+) int8 batch=(\d+): ([0-9.]+) ms/iter, ([0-9.]+) img/s$")


def _save_checkpoint(tmp_path, sd):
    path = tmp_path / "checkpoint.pth.tar"
    torch.save({"model": {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}}, path)
    return path


@pytest.mark.parametrize("family", ["vit", "swin"])
def test_convert_torch_checkpoint_roundtrip(family, tmp_path, capsys):
    """deit_tiny's and swin_tiny's head counts, from their registered configs."""
    if family == "vit":
        sd, argv = reference_vit_state(), ["--model", "deit_tiny"]
        expect = jax_ingest.torch_vit_state_to_artifact(sd, num_heads=3)
    else:
        sd, argv = reference_swin_state(), ["--model", "swin_tiny", "--input-size", str(SWIN_TINY["img_size"])]
        expect = jax_ingest.torch_swin_state_to_artifact(sd, num_heads=(3, 6, 12, 24), img_size=SWIN_TINY["img_size"])
    out = tmp_path / "artifact.pkl"
    convert_model.main(argv + ["--torch-checkpoint", str(_save_checkpoint(tmp_path, sd)), "--output", str(out)])
    assert f"wrote {out} (ingested reference checkpoint" in capsys.readouterr().out
    with open(out, "rb") as f:
        assert_same(pickle.load(f), expect)


@pytest.mark.parametrize("argv, message", [
    (["--model", "deit_small", "--checkpoint", "ckpt.pkl"], "comes with the QAT port"),
    (["--model", "deit_small", "--torch-checkpoint", "x.pth", "--export-engine", "e.bin"],
     "comes with the serialized-engine slice"),
    (["--torch-checkpoint", "x.pth"], "requires a --model name"),
    (["--model", "deit_small"], "pass exactly one of --checkpoint"),
], ids=["checkpoint", "export-engine", "no-model", "no-input"])
def test_convert_refusals_exit_with_their_message(argv, message, tmp_path):
    with pytest.raises(SystemExit) as info:
        convert_model.main(argv + ["--output", str(tmp_path / "a.pkl")])
    assert message in str(info.value.code)
    assert not (tmp_path / "a.pkl").exists()


@pytest.mark.parametrize("argv", [
    ["--model", "deit_tiny", "--input-size", "32", "--softmax-bits", "8", "--gelu-stable"],
    ["--model", "deit_tiny", "--input-size", "32", "--batch-size", "2", "--kernels", ""],
    ["--model", "swin_tiny", "--kernels", "attention"],
], ids=["vit-default-kernels", "vit-plain-batch2", "swin-attention"])
def test_evaluate_latency_on_cpu_prints_its_line(argv, capsys):
    dt = evaluate_latency.main(argv + ["--device", "cpu", "--repeat", "2", "--nb-classes", "10"])
    lines = capsys.readouterr().out.strip().splitlines()
    m = LATENCY_LINE.match(lines[-1])
    assert m and m.group(1) == argv[1] and int(m.group(2)) == (2 if "--batch-size" in argv else 1)
    assert dt > 0 and lines[0].startswith("engine: kernels ")
    if "--kernels" in argv:
        assert lines[0] == f"engine: kernels {sorted(evaluate_latency.parse_kernels(argv[-1]))}"


def test_evaluate_latency_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evaluate_latency.main(["--model", "deit_tiny", "--input-size", "32", "--repeat", "1"])


@pytest.fixture
def jax_bench(monkeypatch):
    """The root bench.py, imported as it is, with JAX's persistent
    compilation cache off (bench.py turns it on at import)."""
    monkeypatch.setenv("IVIT_XLA_CACHE", "off")
    return importlib.import_module("bench")


# float32 forwards in two frameworks on the same CPU: the same products
# in possibly different summation orders
FP32_RTOL = 1e-6


@pytest.mark.parametrize("bits", [8, 16])
def test_bench_float_leg_matches_jax_bench(bits, jax_bench):
    art = synthetic_vit_artifact("deit_tiny", seed=0, softmax_bits=bits, gelu_stable=bits == 8,
                                 img_size=32, patch_size=8, embed_dim=128, depth=2, num_heads=2)
    images = np.random.default_rng(3).standard_normal((2, 32, 32, 3)).astype(np.float32)
    ours = bench._float_vit_infer(art, "cpu")(torch.from_numpy(images)).numpy()
    theirs = np.asarray(jax_bench._float_vit_infer(art)(jnp.asarray(images)))
    assert ours.dtype == np.float32 and ours.shape == theirs.shape == (2, 1000)
    assert np.abs(ours - theirs).max() <= FP32_RTOL * np.abs(theirs).max()
    bench.assert_fp32_highest()  # building the leg turned TF32 off


def test_bench_main_on_cpu_prints_bench_keys(monkeypatch, capsys):
    monkeypatch.setattr(bench, "BATCH", 1)
    monkeypatch.setattr(bench, "ITERS", 1)
    monkeypatch.setattr(bench, "REPS", 2)
    result = bench.main(["--device", "cpu"])
    captured = capsys.readouterr()
    lines = captured.out.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == result
    assert set(result) == BENCH_KEYS and result["metric"] == "deit_small_int8_images_per_sec_per_gpu"
    assert result["unit"] == "images/sec" and result["value"] > 0 and np.isfinite(result["vs_baseline"])
    assert "card: " in captured.err and captured.err.count("reps [") == 2


def test_bench_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main([])


def test_capture_infer_raises_on_cpu():
    art = synthetic_vit_artifact("deit_tiny", seed=0, img_size=32, patch_size=8, embed_dim=128, depth=2, num_heads=2)
    with pytest.raises(RuntimeError, match="CUDA graphs need a CUDA device"):
        capture_infer(build_vit_infer(art, "cpu"), 1, 32, device="cpu")


def test_forward_scalars_are_carried_as_tensors():
    """Route B's context ratio and Swin's pool 1/L are carried tensors
    holding the kernel arguments' float32 values; the carried 1/L gives
    the pool the value it divides for itself."""
    art = synthetic_vit_artifact("deit_tiny", seed=0, softmax_bits=16, gelu_stable=False,
                                 img_size=32, patch_size=8, embed_dim=128, depth=2, num_heads=2)
    for blk in build_vit_infer(art, "cpu", kernels=()).tensors["blocks"]:
        a = blk["attn"]
        assert a["ratio_out"].dtype == torch.float32 and float(a["ratio_out"]) == a["r_out"]
    t = build_swin_infer(synthetic_swin_artifact("swin_tiny", seed=0, **SWIN_TINY), "cpu").tensors
    assert float(t["inv_tokens"]) == float(np.float32(1.0) / np.float32(4))  # 2 x 2 tokens at the last stage
    y = torch.randint(-128, 128, (2, 49, 8), dtype=torch.int32).to(torch.float32)
    inv49 = torch.tensor(np.float32(1.0) / np.float32(49))
    assert torch.equal(token_mean(y, inv49), token_mean(y))


def test_f32_on_the_cpu_is_a_fresh_tensor():
    a, b = f32(0.1, "cpu"), f32(0.1, "cpu")
    assert a is not b and a.dtype == torch.float32 and float(a) == float(np.float32(0.1))
