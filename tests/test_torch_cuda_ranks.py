"""The port's multi-process paths on the card: ranks of
``tests/torch_parallel_worker.py`` sharing one card over an explicitly
named ``gloo`` group (the collectives staged through the host) or a world
of one over ``nccl``, each held to the single-process run on the card.

Every test here needs a CUDA device and skips without one. The file
imports no JAX, so it runs on a machine without it; from the repository
root, after ``tests/test_torch_cuda.py``:

    python -m pytest tests/test_torch_cuda.py tests/test_torch_cuda_ranks.py -m cuda -q --noconftest -p no:cacheprovider
"""

import numpy as np
import pytest
import torch

from ivit_tpu_torch.deploy.engine import build_vit_infer
from ivit_tpu_torch.deploy.swin_engine import build_swin_infer
from ivit_tpu_torch.deploy.swin_synthetic import synthetic_swin_artifact
from ivit_tpu_torch.deploy.synthetic import synthetic_vit_artifact
from ivit_tpu_torch.train import MixupConfig, mixup_cutmix

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


# the tiny QAT model of tests/test_torch_qat_model.py
QAT_TINY = dict(img_size=16, patch_size=8, num_classes=8, embed_dim=32, depth=2, num_heads=4)
# tiny engines and steps
TP_TINY = dict(img_size=16, patch_size=8, embed_dim=64, depth=2, num_heads=4, num_classes=16)


def _tp_case():
    art = synthetic_vit_artifact("deit_tiny", seed=1, **TP_TINY)
    images = np.random.default_rng(8).standard_normal((4, 16, 16, 3)).astype(np.float32)
    return art, images, build_vit_infer(art, "cpu", kernels=())(torch.from_numpy(images)).numpy()


def test_nccl_world_of_one(dev, tmp_path):
    """A world of one over nccl: the engine on a (1, 1) mesh (its
    all-reduces and gathers over one-rank nccl groups) equal to the plain
    engine on the CPU with 2 K1 + 5 K3 + 2 K9 launches a forward; a ZeRO-1 step
    on it equal bit for bit to the single-process step."""
    from torch_parallel_worker import run_ranks, serve_on_card

    art, images, cpu = _tp_case()
    targets = np.full((4, 8), 0.1 / 8, np.float32)
    targets[np.arange(4), [1, 5, 0, 7]] += 0.9
    spec = {"model": "deit_tiny", "model_kw": dict(QAT_TINY, drop_path_rate=0.1), "lr": 1e-3,
            "batches": [(images, targets, 5)]}
    [r] = run_ranks(1, tmp_path, serve_on_card, art, images, (1, 1), spec, backend="nccl", device="cuda")
    np.testing.assert_array_equal(r["logits"], cpu)
    assert r["launches"] == {"K1": 2, "K3": 5, "K9": 2}
    for name, p in r["plain"].items():
        assert torch.equal(r["zero1"][name], p), name


def test_two_gloo_ranks_share_the_card_tp2(dev, tmp_path):
    """Two ranks on cuda:0 over an explicitly named gloo group (the
    collectives staged through the host): tensor-parallel tiny DeiT on
    K1 + K3 + K9, each rank's logits equal to the plain engine on the CPU,
    each rank launching 2 K1 (on its 2 of 4 heads) + 5 K3 (full rows) +
    2 K9 (on its half of fc1's columns) a forward."""
    from torch_parallel_worker import run_ranks, serve_on_card

    art, images, cpu = _tp_case()
    ranks = run_ranks(2, tmp_path, serve_on_card, art, images, (1, 2), backend="gloo", device="cuda")
    for r in ranks:
        assert r["device"] == "cuda:0" and r["kernels"] == ["attention", "gelu_stable", "layernorm"]
        np.testing.assert_array_equal(r["logits"], cpu)
        assert r["launches"] == {"K1": 2, "K3": 5, "K9": 2}


# the tiny DeiT of tests/test_torch_parallel_tp_train.py: 17 tokens, 4 heads
TP_TRAIN_VIT = dict(img_size=16, patch_size=4, num_classes=8, embed_dim=32, depth=2, num_heads=4,
                    drop_rate=0.1, attn_drop_rate=0.1, drop_path_rate=0.1)


@pytest.mark.parametrize("seq", [False, True], ids=["tp", "sp"])
def test_two_gloo_ranks_train_tensor_parallel_on_the_card(dev, tmp_path, seq):
    """Two ranks on cuda:0 over gloo take two tensor-parallel QAT steps
    (sequence-parallel with ``sp``: 17 tokens as 9 and 8): both steps'
    logits and every range equal the single-process step's on the card,
    tolerance 0; the first gradient within 1e-5 of each leaf's largest
    entry (the model group's float32 sums in another order)."""
    from torch_parallel_worker import run_ranks, tp_variant, train_tp

    rng = np.random.default_rng(21)
    batches = []
    for i in range(2):
        t = np.full((8, 8), 0.1 / 8, np.float32)
        t[np.arange(8), rng.integers(0, 8, 8)] += 0.9
        batches.append((rng.standard_normal((8, 16, 16, 3)).astype(np.float32), t, 1000 + i))
    spec = {"model": "deit_tiny", "model_kw": TP_TRAIN_VIT, "lr": 1e-3, "wd": 0.05, "ema": 0.9, "clip": 1.0,
            "batches": batches, "device": "cuda", "seq": seq}
    single = tp_variant(spec, None)
    ranks = run_ranks(2, tmp_path, train_tp, [(spec, (1, 2))], backend="gloo", device="cuda")
    for r in (rk[0] for rk in ranks):
        for i, ref in enumerate(single["steps"]):
            torch.testing.assert_close(r["steps"][i]["logits"], ref["logits"], rtol=0, atol=0, msg=f"step {i}")
            for name, b in ref["ranges"].items():
                assert torch.equal(r["steps"][i]["ranges"][name], b), (i, name)
        for name, g in single["grads"].items():
            torch.testing.assert_close(r["grads"][name], g, rtol=0, atol=1e-5 * float(g.abs().max()), msg=name)


# ---- the published widths and depths -------------------------------------------------------------

SM8 = dict(softmax_bits=8, gelu_stable=True)
# a step's loss within 4 float32 ulps of the single-process step's; the
# first gradient within 1e-5 of each leaf's largest entry (the model
# group's float32 sums in another order); each parameter after step 1
# within 1e-3·lr where its gradient is at least 1e-2 of its leaf's
# largest, else within Adam's 3·lr (a gradient near eps: its rounding
# moves the update), plus 2^-22 relative (tests/test_torch_parallel_train.py)
LOSS_ULPS, GRAD_RTOL = 4, 1e-5
LR, PARAM_ATOL, SMALL_GRAD, ADAM_ATOL = 1e-3, 1e-3 * 1e-3, 1e-2, 3 * 1e-3


def _within_ulps(loss, ref) -> bool:
    """``loss`` within LOSS_ULPS float32 ulps of ``ref``."""
    return abs(np.float32(loss) - np.float32(ref)) <= LOSS_ULPS * np.spacing(np.abs(np.float32(ref)))


def _params1_within(got, single) -> None:
    """The parameters after step 1 within the bounds above of the
    single-process step's."""
    for n, p in single["params1"].items():
        g = single["grads"][n].abs()
        atol = torch.where(g >= SMALL_GRAD * g.max(), PARAM_ATOL, ADAM_ATOL)
        assert bool(((got[n] - p).abs() <= atol + 2.0**-22 * p.abs()).all()), n


def _grads_within(got, single) -> None:
    """The first gradient within GRAD_RTOL of each leaf's largest entry of
    the single-process step's."""
    for n, g in single["grads"].items():
        assert float((got[n] - g).abs().max()) <= GRAD_RTOL * max(float(g.abs().max()), 1e-30), n


def _mixed_batches(key, steps, batch):
    """Seeded normal 224² images with mixup/cutmix targets (quant_train's
    defaults), drawn on the host."""
    out = []
    for i in range(steps):
        rng = np.random.default_rng((0, key, i))
        x = torch.from_numpy(rng.standard_normal((batch, 224, 224, 3), dtype=np.float32))
        labels = torch.from_numpy(rng.integers(0, 1000, batch))
        x, t = mixup_cutmix(x, labels, MixupConfig(), np.random.default_rng((0, key, i, 1)), device="cpu")
        out.append((x.numpy(), t.numpy()))
    return out


def test_two_gloo_ranks_serve_the_published_paths(dev, tmp_path):
    """Two ranks on cuda:0 over gloo at DeiT-S's and Swin-T's published
    widths and depths, on 128 images: the main path data-parallel and
    tensor-parallel (also at batch 1), route B and Swin-T tensor-parallel,
    every rank's logits equal to the single-process engine's on the card
    and its launches a forward 12 K1 + 25 K3 + 12 K9, 12 K6 + 12 K5 + 25
    K3 and 12 K7 + 28 K3; route A (K4) under the model axis raises; K1,
    K3, K5, K6 and K7 (each stage's first two blocks) equal their plain
    versions on each rank's own inputs."""
    from torch_parallel_worker import ROUTE_B, run_ranks, serve_paths_on_card

    art8 = synthetic_vit_artifact("deit_small", seed=0, **SM8)
    art16 = synthetic_vit_artifact("deit_small", seed=0, softmax_bits=16, gelu_stable=False)
    swin = synthetic_swin_artifact("swin_tiny", seed=0)
    images = np.random.default_rng(1).standard_normal((128, 224, 224, 3), dtype=np.float32)
    x = torch.from_numpy(images).to(dev)
    with torch.inference_mode():
        main = build_vit_infer(art8, dev)(x).cpu()
        refs = {"main DP": main, "main TP": main, "main TP batch 1": main[:1],
                "B TP": build_vit_infer(art16, dev, kernels=ROUTE_B)(x).cpu(),
                "swin TP": build_swin_infer(swin, dev)(x).cpu()}
    del x
    torch.cuda.empty_cache()
    vit8, vit16 = {"K1": 12, "K3": 25, "K9": 12}, {"K6": 12, "K5": 12, "K3": 25}
    expect = {"main DP": vit8, "main TP": vit8, "main TP batch 1": vit8, "B TP": vit16, "swin TP": {"K7": 12, "K3": 28}}
    for r in run_ranks(2, tmp_path, serve_paths_on_card, art8, art16, swin, images, backend="gloo", device="cuda"):
        assert r["device"] == "cuda:0" and r["k4_raises"]
        for label, (logits, launches) in r["paths"].items():
            torch.testing.assert_close(logits, refs[label], rtol=0, atol=0, msg=label)
            assert launches == expect[label], label
        assert r["kernel_errors"].keys() >= {"K1", "K3", "K5", "K6", "K7 stage 1 block 1 masked", "K7 stage 4 block 1"}
        assert all(e == 0 for e in r["kernel_errors"].values()), r["kernel_errors"]


def test_two_gloo_ranks_train_data_parallel_on_the_card(dev, tmp_path):
    """DeiT-S QAT at full width and depth on two ranks sharing cuda:0 over
    gloo, a global batch of 64 (32 rows a rank; drop path 0.1,
    mixup/cutmix) for two steps, data-parallel and with ZeRO-1, against
    the single-process step on the card: step 1's logits and every range
    equal (the same parameters), its loss within 4 float32 ulps, the
    parameters after it within the bounds above; ZeRO-1 equal to data
    parallelism bit for bit with smaller moments a rank; the ranks'
    parameters the same."""
    from torch_parallel_worker import run_ranks, tp_variant, train_tp

    batches = [(x, t, 1000 + i) for i, (x, t) in enumerate(_mixed_batches(12, 2, 64))]
    spec = {"model": "deit_small", "model_kw": {"drop_path_rate": 0.1}, "lr": LR, "wd": 0.05, "ema": 0.9,
            "clip": 1.0, "batches": batches, "device": "cuda"}
    single = tp_variant(spec, None)
    torch.cuda.empty_cache()
    ranks = run_ranks(2, tmp_path, train_tp, [(spec, (2, 1)), (dict(spec, zero1=True), (2, 1))], backend="gloo",
                      device="cuda")
    ref = single["steps"][0]
    for rank, (dp, zero1) in enumerate(ranks):
        step = dp["steps"][0]
        torch.testing.assert_close(step["logits"], ref["logits"][32 * rank:32 * (rank + 1)], rtol=0, atol=0)
        assert all(torch.equal(step["ranges"][n], b) for n, b in ref["ranges"].items())
        assert _within_ulps(step["loss"], ref["loss"])
        _params1_within(dp["params1"], single)
        assert [s["loss"] for s in zero1["steps"]] == [s["loss"] for s in dp["steps"]]
        assert all(torch.equal(a["logits"], b["logits"]) for a, b in zip(zero1["steps"], dp["steps"]))
        for key in ("params", "ema", "mu", "nu"):
            assert all(torch.equal(zero1[key][n], t) for n, t in dp[key].items()), key
        assert sum(map(np.prod, zero1["local_mu"].values())) < sum(map(np.prod, dp["local_mu"].values()))
    assert all(torch.equal(ranks[1][0]["params"][n], p) for n, p in ranks[0][0]["params"].items())


@pytest.mark.parametrize("name, model_kw, launches", [
    ("deit_small", SM8, {"K1": 12, "K3": 25, "K9": 12}),
    ("swin_tiny", {}, {"K7": 12, "K3": 28}),
], ids=["deit_s", "swin_t"])
def test_tp_trained_models_serve_on_the_card(dev, tmp_path, name, model_kw, launches):
    """DeiT-S (sm8, the stable GELU) and Swin-T at full width and depth
    trained tensor-parallel on two ranks sharing cuda:0 over gloo (two
    steps at a global batch of 8, drop path 0.1, mixup/cutmix) against
    the single-process step on the card: step 1's logits and every range
    equal, its loss within 4 ulps, the first gradient within 1e-5 of each
    leaf's largest entry, the parameters after step 1 within the bounds
    above. Gathered whole, frozen and served by
    ``shard_infer_tp`` on the same mesh at batch 32: every rank's logits
    equal to the single-process engine's, its launches a forward, and the
    kernels (K1 and K3; K3 and K7 by stage) equal to their plain versions
    on the rank's own inputs."""
    from torch_parallel_worker import run_ranks, serve_tp_trained_on_card, tp_variant

    batches = [(x, t, 1000 + i) for i, (x, t) in enumerate(_mixed_batches(13, 2, 8))]
    spec = {"model": name, "model_kw": dict(model_kw, drop_path_rate=0.1), "lr": LR, "wd": 0.05, "ema": 0.9,
            "clip": 1.0, "batches": batches, "device": "cuda"}
    images = np.random.default_rng((0, 13)).standard_normal((32, 224, 224, 3), dtype=np.float32)
    single = tp_variant(spec, None)
    torch.cuda.empty_cache()
    for r in run_ranks(2, tmp_path, serve_tp_trained_on_card, spec, (1, 2), images, backend="gloo", device="cuda"):
        assert r["device"] == "cuda:0"
        step, ref = r["steps"][0], single["steps"][0]
        torch.testing.assert_close(step["logits"], ref["logits"], rtol=0, atol=0)
        assert all(torch.equal(step["ranges"][n], b) for n, b in ref["ranges"].items())
        assert _within_ulps(step["loss"], ref["loss"])
        _grads_within(r["grads"], single)
        _params1_within(r["params1"], single)
        torch.testing.assert_close(r["logits"], r["single"], rtol=0, atol=0)
        assert r["launches"] == launches
        assert all(e == 0 for e in r["kernel_errors"].values()), r["kernel_errors"]


SM16 = dict(softmax_bits=16, gelu_stable=False)
# DeiT-S trained on a mesh (data, model) in each variant: (label, the
# model's options, tp_variant's flags)
TP_VARIANTS = {
    (1, 2): [("sm16 TP", SM16, {}), ("sm16 SP", SM16, {"seq": True}), ("sm8 SP", SM8, {"seq": True})],
    (2, 2): [("sm16 TP", SM16, {}), ("sm16 TP ZeRO-1 remat", SM16, {"zero1": True, "remat": True}),
             ("sm16 SP ZeRO-1 remat", SM16, {"seq": True, "zero1": True, "remat": True})],
}


@pytest.mark.parametrize("mesh", sorted(TP_VARIANTS), ids=["1x2", "2x2"])
def test_tensor_parallel_variants_at_deit_s_width_on_the_card(dev, tmp_path, mesh):
    """DeiT-S at full width and depth trained on ranks sharing cuda:0 over
    gloo (two steps at a global batch of 8, drop path 0.1, mixup/cutmix)
    against the single-process step on the card. On a (1, 2) mesh: sm16
    tensor- and sequence-parallel (197 tokens as 99 and 98) and sm8
    sequence-parallel; on a (2, 2) mesh of four ranks: sm16
    tensor-parallel, with ZeRO-1 and ``remat``, and sequence-parallel with
    both. Each: step 1's logits (the data rows in order) and every range
    equal to the single-process step's, its loss within 4 ulps, the first
    gradient within 1e-5 of each leaf's largest entry, the parameters after
    step 1 within the bounds above; each sm16 variant so against sm16
    tensor parallelism alone too. With ZeRO-1 each rank holds smaller
    moments than tensor parallelism alone, and tensor parallelism with
    ZeRO-1 and ``remat`` equals it bit for bit (both steps' logits, the
    first gradient, the parameters, the EMA and the moments)."""
    from torch_parallel_worker import run_ranks, tp_variant, train_tp

    batches = [(x, t, 1000 + i) for i, (x, t) in enumerate(_mixed_batches(13, 2, 8))]
    variants = TP_VARIANTS[mesh]
    specs = [{"model": "deit_small", "model_kw": dict(kw, drop_path_rate=0.1), "lr": LR, "wd": 0.05, "ema": 0.9,
              "clip": 1.0, "batches": batches, "device": "cuda", **flags} for _, kw, flags in variants]
    singles = {}
    for (label, _, _), spec in zip(variants, specs):
        model = label.split()[0]
        if model not in singles:
            singles[model] = tp_variant({k: v for k, v in spec.items() if k not in ("seq", "zero1", "remat")}, None)
            torch.cuda.empty_cache()
    world = mesh[0] * mesh[1]
    ranks = run_ranks(world, tmp_path, train_tp, [(spec, mesh) for spec in specs], backend="gloo", device="cuda")
    rows = 8 // mesh[0]
    for rank, recs in enumerate(ranks):
        d = rank // mesh[1]
        for (label, _, _), r in zip(variants, recs):
            single = singles[label.split()[0]]
            step, ref = r["steps"][0], single["steps"][0]
            torch.testing.assert_close(step["logits"], ref["logits"][rows * d:rows * (d + 1)], rtol=0, atol=0,
                                       msg=label)
            assert all(torch.equal(step["ranges"][n], b) for n, b in ref["ranges"].items()), label
            assert _within_ulps(step["loss"], ref["loss"]), label
            _grads_within(r["grads"], single)
            _params1_within(r["params1"], single)
        by_label = {label: r for (label, _, _), r in zip(variants, recs)}
        tp = by_label["sm16 TP"]
        for label, r in by_label.items():
            if label.startswith("sm16") and r is not tp:  # held to tensor parallelism alone as to one process
                step = r["steps"][0]
                torch.testing.assert_close(step["logits"], tp["steps"][0]["logits"], rtol=0, atol=0, msg=label)
                assert all(torch.equal(step["ranges"][n], b) for n, b in tp["steps"][0]["ranges"].items()), label
                assert _within_ulps(step["loss"], tp["steps"][0]["loss"]), label
                _grads_within(r["grads"], tp)
                _params1_within(r["params1"], tp)
            if "ZeRO-1" in label:
                assert sum(map(np.prod, r["local_mu"].values())) < sum(map(np.prod, tp["local_mu"].values())), label
        if "sm16 TP ZeRO-1 remat" in by_label:
            a, b = by_label["sm16 TP ZeRO-1 remat"], by_label["sm16 TP"]
            assert all(torch.equal(x["logits"], y["logits"]) for x, y in zip(a["steps"], b["steps"]))
            for key in ("grads", "params", "ema", "mu", "nu"):
                assert all(torch.equal(a[key][n], t) for n, t in b[key].items()), key


def test_gpipe_on_the_card(dev, tmp_path):
    """GPipe on two ranks sharing cuda:0 over gloo, a stage of 6 blocks
    each: DeiT-S (sm8, the stable GELU) at full width and depth, its
    ranges set by one batch, on a ``(data, pipe) = (1, 2)`` mesh, a global
    batch of 8 in 4 microbatches. The pipelined frozen logits equal the
    single-process forward's and the single-stage step's (tolerance 0);
    step 1's loss within 4 ulps, its gradient within 1e-5 of each leaf's
    largest entry and the parameters after it within the bounds above;
    each rank holds AdamW's two moments and the EMA of its stage alone.
    The pipe-trained model, gathered whole, frozen and served by
    ``build_vit_infer`` at batch 32: 12 K1 + 25 K3 + 12 K9 a forward, the
    logits equal to ``kernels=()``'s, K1 and K3 equal to their plain
    versions on its inputs."""
    from torch_parallel_worker import pipeline_on_card, run_ranks

    rng = np.random.default_rng((0, 14))
    calib = rng.standard_normal((8, 224, 224, 3), dtype=np.float32)
    images = rng.standard_normal((32, 224, 224, 3), dtype=np.float32)
    ranks = run_ranks(2, tmp_path, pipeline_on_card, "deit_small", SM8, _mixed_batches(14, 2, 8), calib, images, 4,
                      backend="gloo", device="cuda")
    stage_params = 757_096 + 6 * 1_774_464  # the prologue and epilogue, and 6 of the 12 blocks
    for r in ranks:
        assert r["device"] == "cuda:0" and r["opt_bytes"] == 3 * 4 * stage_params
    r = ranks[0]
    pipe, single = r["pipe"], r["single"]
    torch.testing.assert_close(pipe["logits"], r["forward"], rtol=0, atol=0)
    torch.testing.assert_close(pipe["logits"], single["logits"], rtol=0, atol=0)
    _grads_within(pipe["grads"], single)
    assert _within_ulps(pipe["loss"][0], single["loss"][0])
    _params1_within(pipe["params1"], single)
    served = r["served"]
    assert served["launches"] == {"K1": 12, "K3": 25, "K9": 12}
    torch.testing.assert_close(served["logits"], served["plain"], rtol=0, atol=0)
    assert all(e == 0 for e in served["kernel_errors"].values()), served["kernel_errors"]


def test_torchrun_world_of_one_over_nccl(dev, tmp_path):
    """The CLIs as a user launches them on one card: ``python -m
    torch.distributed.run --standalone --nproc-per-node 1`` runs
    ``quant_train --distributed --zero1`` (DeiT-S at 224², two steps at
    batch 32) over nccl, and its checkpoint equals the same run's without
    ``--distributed`` leaf for leaf; then ``evaluate_accuracy --mesh-data
    1`` over nccl on the converted result gives the single-process
    sweep's logits and labels, with 12 K1 + 25 K3 a captured forward."""
    import ast
    import os
    import re
    import subprocess
    import sys

    from ivit_tpu_torch import convert_model, evaluate_accuracy, quant_train
    from ivit_tpu_torch.nn.flax_state import flatten
    from ivit_tpu_torch.utils import load_checkpoint_raw

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    def torchrun(*args):
        run = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node=1",
                              "-m", *args], cwd=repo, capture_output=True, text=True, timeout=600)
        assert run.returncode == 0, run.stderr[-4000:]
        return run.stdout

    def flat(path):
        state, extra = load_checkpoint_raw(path)
        return {**flatten(state), **{f"extra.{k}": v for k, v in extra.items()}}

    data = ["--data-set", "SYNTHETIC", "--input-size", "224", "--nb-classes", "1000"]
    train = data + ["--aa", "none", "--color-jitter", "0", "--best-acc1", "-1", "--print-freq", "1",
                    "--model", "deit_small", "--batch-size", "32", "--max-steps-per-epoch", "2", "--epochs", "1"]
    d1, d0 = tmp_path / "dist", tmp_path / "single"
    out = torchrun("ivit_tpu_torch.quant_train", *train, "--distributed", "--zero1", "--output-dir", str(d1))
    assert "1 ranks over nccl" in out + (d1 / "log.log").read_text()
    quant_train.main(train + ["--device", "cuda", "--output-dir", str(d0)])
    got, want = flat(str(d1 / "checkpoint.pkl")), flat(str(d0 / "checkpoint.pkl"))
    assert got.keys() == want.keys()
    assert not [k for k in want if not np.array_equal(np.asarray(got[k]), np.asarray(want[k]))]
    art = str(tmp_path / "artifact.pkl")
    convert_model.main(["--checkpoint", str(d1 / "checkpoint.pkl"), "--output", art, "--device", "cuda"])
    ev = ["--model", "deit_small", "--artifact", art, *data, "--batch-size", "64", "--max-batches", "1"]
    out = torchrun("ivit_tpu_torch.evaluate_accuracy", *ev, "--mesh-data", "1",
                   "--dump-logits", str(tmp_path / "e1.npz"))
    evaluate_accuracy.main(ev + ["--device", "cuda", "--dump-logits", str(tmp_path / "e0.npz")])
    assert "over nccl" in out
    captured = re.search(r"launches a forward (\{.*\})", out)
    assert captured is not None and ast.literal_eval(captured.group(1)) == {"K1": 12, "K3": 25}
    a, b = np.load(tmp_path / "e1.npz"), np.load(tmp_path / "e0.npz")
    np.testing.assert_array_equal(a["logits"], b["logits"])
    np.testing.assert_array_equal(a["labels"], b["labels"])
