#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``ivit_tpu_torch``) on one NVIDIA GPU.

Drives the port's main path — integer-only DeiT-S inference
(``deploy.engine.build_vit_infer``, softmax_bits=8, stable ShiftGELU) at
full width on a seeded synthetic artifact — and checks every hand-written
kernel on it:

1. the card's name and power limit (``nvidia-smi``);
2. builds the CUDA kernels from ``ivit_tpu_torch/csrc`` with nvcc;
3. K1 (fused attention) and K3 (fused I-LayerNorm → requant) against
   their plain torch versions, bit for bit, at the main path's shapes:
   K3 on (25216, 384) and (197, 384), K1 on (768, 197, 64) and
   (6, 197, 64) at out_bits 8 and 16 — on the engine's own block-0
   inputs and on random inputs with spread scores;
4. the engine on the card at batch 128 and batch 1: logits bit-equal to
   the plain ops on the card, to the plain engine on the CPU (first two
   images), batch 1 equal to row 0 of batch 128, and 12 K1 + 25 K3
   launches per forward;
5. times (CUDA events after warm-up): engine images/s at batch 128,
   ms/image at batch 1, and each kernel beside its plain version; then a
   torch.profiler table of one batch-128 forward (device time by op).

Any failed check raises and exits nonzero before the result lines. The
second-to-last line is the kernels' JSON record, the last line
``{"ok": true, "device": {...}}``. Exits nonzero without a CUDA device
or without the package beside it.

Usage: ``python3 chip_smoke.py`` from the repository root (one card).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 0
BATCH = 128


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device milliseconds per call, CUDA events around ``iters`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def paired_ms(kernel_fn, plain_fn, iters: int) -> tuple[float, float]:
    """Kernel and plain times in the order plain, kernel, kernel, plain."""
    p1 = cuda_ms(plain_fn, iters)
    k1 = cuda_ms(kernel_fn, iters)
    k2 = cuda_ms(kernel_fn, iters)
    p2 = cuda_ms(plain_fn, iters)
    return (k1 + k2) / 2, (p1 + p2) / 2


def max_abs_err(a, b) -> int:
    return int((a.to(dtype=b.dtype).long() - b.long()).abs().max())


def main() -> int:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(REPO, "ivit_tpu_torch")):
        print("chip_smoke: the ivit_tpu_torch package is not beside this script", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from ivit_tpu_torch.deploy.engine import attention_inputs, build_vit_infer, embed
    from ivit_tpu_torch.deploy.synthetic import nonzero_probability_share, synthetic_vit_artifact
    from ivit_tpu_torch.kernels import (
        _build,
        fused_int8_attention,
        fused_int8_attention_reference,
        fused_layernorm_requant,
        fused_layernorm_requant_reference,
    )
    from ivit_tpu_torch.kernels.attention_fused import attention_probabilities

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    dev = torch.device("cuda", 0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    # 2. build
    t0 = time.perf_counter()
    _build.build(force=True)
    _build.load()
    print(f"build: nvcc {' '.join(_build.NVCC_FLAGS)} -> {_build.LIB} in {time.perf_counter() - t0:.3f} s")

    # the main path's inputs
    t0 = time.perf_counter()
    artifact = synthetic_vit_artifact("deit_small", seed=SEED, softmax_bits=8, gelu_stable=True)
    cfg = artifact["config"]
    print(f"artifact: synthetic deit_small seed={SEED} {cfg} in {time.perf_counter() - t0:.3f} s")
    rng = np.random.default_rng(SEED + 1)
    images = torch.from_numpy(rng.standard_normal((BATCH, 224, 224, 3), dtype=np.float32))
    images_dev = images.to(dev)
    infer = build_vit_infer(artifact, dev)
    t = infer.tensors
    blk0 = t["blocks"][0]
    H = cfg["num_heads"]

    # 3. kernels against their plain versions at the main path's shapes
    with torch.inference_mode():
        x128 = embed(images_dev, t)
        x1 = embed(images_dev[:1], t)
    k3_cases = {
        "(25216, 384)": x128.reshape(-1, cfg["embed_dim"]),
        "(197, 384)": x1.reshape(-1, cfg["embed_dim"]),
    }
    k3_err = 0
    for shape, x in k3_cases.items():
        args = (x, blk0["norm1"]["bias_int"], blk0["norm1"]["ratio"])
        out = fused_layernorm_requant(*args)
        ref = fused_layernorm_requant_reference(*args)
        torch.cuda.synchronize()
        err = max_abs_err(out, ref)
        k3_err = max(k3_err, err)
        print(f"K3 {shape}: max_abs_err {err} (tolerance 0), distinct outputs {int(ref.unique().numel())}")
        check(err == 0, f"K3 {shape} differs from its plain version")

    s = {k: np.float32(artifact["blocks"][0][k]) for k in ("s_attn_qact1", "s_attn_sm_in", "s_attn_out")}
    a0 = blk0["attn"]
    gen = torch.Generator().manual_seed(SEED)
    k1_err = 0
    k1_inputs = {}
    for shape, x in (("(768, 197, 64)", x128), ("(6, 197, 64)", x1)):
        with torch.inference_mode():
            q, k, v = attention_inputs(x, blk0, H)
        k1_inputs[shape] = (q, k, v)
        G, N, hd = q.shape
        rand = [torch.randint(-128, 128, (G, N, hd), generator=gen, dtype=torch.int8).to(dev) for _ in range(3)]
        for bits in (8, 16):
            # the block-0 ratios at this probability width (f32, as the engine forms them)
            r_out = float(np.float32(np.float32(1.0 / 2 ** (bits - 1)) * s["s_attn_qact1"]) / s["s_attn_out"])
            spread_r1 = float(np.float32(127.0 / (3 * np.sqrt(hd) * 74.0**2)))
            for data, (qq, kk, vv), r1, scale in (
                ("block0", (q, k, v), a0["r1"], a0["scale"]),
                ("random", rand, spread_r1, float(np.float32(0.07))),
            ):
                out = fused_int8_attention(qq, kk, vv, r1, scale, r_out, bits)
                ref = fused_int8_attention_reference(qq, kk, vv, r1, scale, r_out, bits)
                probs = attention_probabilities(qq, kk, r1, scale, bits)
                torch.cuda.synchronize()
                err = max_abs_err(out, ref)
                k1_err = max(k1_err, err)
                print(
                    f"K1 {shape} out_bits={bits} {data}: max_abs_err {err} (tolerance 0), "
                    f"nonzero probabilities {float((probs > 0).float().mean())}, "
                    f"distinct outputs {int(ref.unique().numel())}"
                )
                check(err == 0, f"K1 {shape} out_bits={bits} {data} differs from its plain version")

    # 4. the main path end to end
    plain_infer = build_vit_infer(artifact, dev, use_kernels=False)
    cpu_infer = build_vit_infer(artifact, "cpu")
    fused_int8_attention.launches = 0
    fused_layernorm_requant.launches = 0
    logits = infer(images_dev)
    logits1 = infer(images_dev[:1])
    torch.cuda.synchronize()
    k1_launches = fused_int8_attention.launches
    k3_launches = fused_layernorm_requant.launches
    depth = cfg["depth"]
    print(f"launches over 2 forwards (batch {BATCH}, batch 1): K1 {k1_launches}, K3 {k3_launches}")
    check(k1_launches == 2 * depth, f"K1 launched {k1_launches} times, expected {2 * depth}")
    check(k3_launches == 2 * (2 * depth + 1), f"K3 launched {k3_launches} times, expected {2 * (2 * depth + 1)}")

    check(tuple(logits.shape) == (BATCH, cfg["num_classes"]), f"logits shape {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits).all()), "non-finite logits")
    plain = plain_infer(images_dev)
    cpu2 = cpu_infer(images[:2])
    e_plain = float((logits - plain).abs().max())
    e_cpu = float((logits[:2].cpu() - cpu2).abs().max())
    e_b1 = float((logits1 - logits[:1]).abs().max())
    print(f"logits batch {BATCH} vs plain ops on the card: max_abs_err {e_plain} (tolerance 0)")
    print(f"logits rows 0-1 vs plain engine on the CPU: max_abs_err {e_cpu} (tolerance 0)")
    print(f"logits batch 1 vs row 0 of batch {BATCH}: max_abs_err {e_b1} (tolerance 0)")
    check(torch.equal(logits, plain), "kernel path differs from the plain ops on the card")
    check(torch.equal(logits[:2].cpu(), cpu2), "card differs from the CPU plain engine")
    check(torch.equal(logits1, logits[:1]), "batch 1 differs from row 0 of the batch")
    shares = nonzero_probability_share(artifact, images[:8], dev)
    argmax = logits.argmax(-1)
    print(
        f"non-degeneracy: nonzero attention probabilities per block {shares}; "
        f"distinct argmax over {BATCH} images {int(argmax.unique().numel())}; "
        f"logit std {float(logits.std())}"
    )

    # 5. timing
    iters = 10
    ms128 = cuda_ms(lambda: infer(images_dev), iters)
    plain_ms128 = cuda_ms(lambda: plain_infer(images_dev), iters)
    print(f"engine batch {BATCH}: {ms128} ms/forward, {BATCH / ms128 * 1e3} images/s "
          f"(plain ops: {plain_ms128} ms, {BATCH / plain_ms128 * 1e3} images/s)")
    lat = []
    for i in range(60):
        t0 = time.perf_counter()
        infer(images_dev[:1])
        torch.cuda.synchronize()
        if i >= 10:
            lat.append((time.perf_counter() - t0) * 1e3)
    lat.sort()
    print(f"engine batch 1: median {lat[len(lat) // 2]} ms/image, min {lat[0]}, max {lat[-1]} "
          f"(host clock, {len(lat)} runs); device {cuda_ms(lambda: infer(images_dev[:1]), 50)} ms/forward")

    timings = {}
    for shape, x in k3_cases.items():
        args = (x, blk0["norm1"]["bias_int"], blk0["norm1"]["ratio"])
        timings[("K3", shape)] = paired_ms(
            lambda: fused_layernorm_requant(*args), lambda: fused_layernorm_requant_reference(*args), 20
        )
    for shape, (q, k, v) in k1_inputs.items():
        args = (q, k, v, a0["r1"], a0["scale"], a0["r_out"], 8)
        timings[("K1", shape)] = paired_ms(
            lambda: fused_int8_attention(*args), lambda: fused_int8_attention_reference(*args), 20
        )
    for (name, shape), (k_ms, p_ms) in timings.items():
        print(f"{name} {shape}: kernel {k_ms} ms, plain {p_ms} ms, plain/kernel {p_ms / k_ms}")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        infer(images_dev)
        torch.cuda.synchronize()
    print(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=20))

    record = {"kernels": [
        {"name": "K1 fused_int8_attention", "route": "cuda",
         "source": "ivit_tpu_torch/csrc/attention_fused.cu",
         "replaces": "ivit_tpu/kernels/attention_fused.py:126",
         "launches": k1_launches, "max_abs_err": k1_err,
         "ms": timings[("K1", "(768, 197, 64)")][0], "plain_ms": timings[("K1", "(768, 197, 64)")][1]},
        {"name": "K3 fused_layernorm_requant", "route": "cuda",
         "source": "ivit_tpu_torch/csrc/intnorm_fused.cu",
         "replaces": "ivit_tpu/kernels/intnorm_fused.py:74",
         "launches": k3_launches, "max_abs_err": k3_err,
         "ms": timings[("K3", "(25216, 384)")][0], "plain_ms": timings[("K3", "(25216, 384)")][1]},
    ]}
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
