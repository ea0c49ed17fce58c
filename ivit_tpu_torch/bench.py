"""Headline benchmark: DeiT-S INT8 inference throughput on one GPU.

Counterpart of the JAX package's ``bench.py``. Prints ONE JSON line:
``{"metric", "value", "unit", "vs_baseline"}``, with

    vs_baseline = (INT8 speedup over a true-FP32 forward) / 3.72

where 3.72 is the reference paper's DeiT-S INT8-over-FP32 claim; the
absolute images/s is the primary value. Run it from the repository root
on the card:

    python -m ivit_tpu_torch.bench

* **INT8 leg:** the shipped configuration, ``deit_small`` with 8-bit
  probabilities and the stable ShiftGELU (``bench.py:154``), on
  ``deploy.synthetic_vit_artifact("deit_small", seed=0, ...)``, through
  the engine's default kernels (K1 attention + K3 LayerNorm).
* **FP32 leg:** ``_float_vit_infer``, op for op the JAX baseline
  (``bench.py:48-117``): the artifact's weights dequantized to float32,
  LayerNorm without affine (eps 1e-6, population variance), an explicit
  matmul → softmax → matmul attention, tanh GELU, float32 throughout with
  TF32 off (``fp32_highest``, asserted before the leg is timed).

Both legs are captured once as CUDA graphs (``deploy.graphs``) and timed
as ``bench.py`` times its compiled functions: two warm calls, then the
best of ``REPS`` runs of ``ITERS`` forwards at ``BATCH`` images, each
ending in a host readback. The runs and their spread, and the card's
name and power limit, go to stderr. ``--device cpu`` runs both legs
eagerly on the CPU (for tests, with ``BATCH`` and ``ITERS`` lowered).
The JAX bench's TPU compiler legs (``sm_packed``, ``licm``) have no
counterpart here.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

BATCH = 128
ITERS = 30
REPS = 3
REF_SPEEDUP = 3.72  # the paper's DeiT-S INT8-over-FP32 claim
METRIC = "deit_small_int8_images_per_sec_per_gpu"


def fp32_highest() -> None:
    """Float32 matmuls in true float32: TF32 off for cuBLAS and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def assert_fp32_highest() -> None:
    assert not torch.backends.cuda.matmul.allow_tf32, "TF32 matmuls are on"
    assert not torch.backends.cudnn.allow_tf32, "TF32 convolutions are on"
    assert torch.get_float32_matmul_precision() == "highest", torch.get_float32_matmul_precision()


def _float_vit_infer(artifact: dict, device="cuda"):
    """True-FP32 ViT forward of ``artifact``'s architecture, with its
    weights dequantized (the values are irrelevant for latency; shapes
    and dtypes are what is timed): NHWC float images → float32 logits.
    Turns TF32 off for the process (``fp32_highest``)."""
    fp32_highest()
    cfg = artifact["config"]
    D, H = cfg["embed_dim"], cfg["num_heads"]
    hd = D // H
    p = cfg["patch_size"]

    def as_f32(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device)

    def deq(layer):
        w = layer["w"].astype(np.float32) * layer["out_scale"]
        b = layer.get("b")
        return as_f32(w), (as_f32(b) if b is not None else None)

    weights = {
        "patch": deq(artifact["patch_embed"]),
        "pos": as_f32(artifact["pos_q"]),
        "cls": as_f32(artifact["cls_q"]),
        "blocks": [{k: deq(blk[k]) for k in ("qkv", "proj", "fc1", "fc2")} for blk in artifact["blocks"]],
        "head": deq(artifact["head"]),
    }

    def ln(x):
        m = x.mean(-1, keepdim=True)
        v = x.var(-1, keepdim=True, unbiased=False)
        return (x - m) * torch.rsqrt(v + 1e-6)

    @torch.inference_mode()
    def infer(images):
        B = images.shape[0]
        gh = cfg["img_size"] // p
        x = images.to(device=device, dtype=torch.float32)
        x = x.reshape(B, gh, p, gh, p, 3).permute(0, 1, 3, 2, 4, 5).reshape(B, gh * gh, p * p * 3)
        w, b = weights["patch"]
        x = torch.matmul(x, w) + b
        x = torch.cat([weights["cls"].expand(B, 1, D), x], 1) + weights["pos"]
        for blk in weights["blocks"]:
            y = ln(x)
            w, b = blk["qkv"]
            qkv = (torch.matmul(y, w) + b).reshape(B, -1, 3, H, hd).permute(2, 0, 3, 1, 4)
            q, k, v = qkv[0], qkv[1], qkv[2]
            attn = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) * hd**-0.5, -1)
            ctx = torch.matmul(attn, v).permute(0, 2, 1, 3).reshape(B, -1, D)
            w, b = blk["proj"]
            x = x + (torch.matmul(ctx, w) + b)
            y = ln(x)
            w, b = blk["fc1"]
            y = torch.nn.functional.gelu(torch.matmul(y, w) + b, approximate="tanh")
            w, b = blk["fc2"]
            x = x + (torch.matmul(y, w) + b)
        x = ln(x)[:, 0]
        w, b = weights["head"]
        return torch.matmul(x, w) + b

    return infer


def time_fn(fn, x) -> float:
    """Best seconds per forward over ``REPS`` runs of ``ITERS`` calls,
    after two warm calls; each run ends in a host readback. The runs and
    their spread go to stderr."""
    float(fn(x)[0, 0])
    float(fn(x)[0, 0])
    times = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        for _ in range(ITERS):
            out = fn(x)
        float(out[0, 0])
        times.append((time.perf_counter() - t0) / ITERS)
    print(f"reps {['%.2f' % (t * 1e3) for t in times]} ms; spread {100 * (max(times) / min(times) - 1):.1f}%",
          file=sys.stderr)
    return min(times)


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` prints them."""
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError, IndexError):
        return "no nvidia-smi"


def main(argv=None) -> dict:
    p = argparse.ArgumentParser("I-ViT int8 vs fp32 throughput (PyTorch)")
    p.add_argument("--device", default="cuda", help="cuda (CUDA graphs) or cpu (eager, for tests)")
    args = p.parse_args(argv)

    from .deploy import build_vit_infer, synthetic_vit_artifact
    from .deploy.artifact import target_device
    from .deploy.graphs import capture_infer

    device = target_device(args.device)
    print(f"card: {card()}", file=sys.stderr)
    artifact = synthetic_vit_artifact("deit_small", seed=0, softmax_bits=8, gelu_stable=True)
    size = artifact["config"]["img_size"]
    images = torch.from_numpy(np.random.default_rng(0).standard_normal((BATCH, size, size, 3)).astype(np.float32))
    images = images.to(device)

    int8_fn = build_vit_infer(artifact, device)
    fp32_fn = _float_vit_infer(artifact, device)
    if device.type == "cuda":
        int8_fn = capture_infer(int8_fn, BATCH, size, device)
        fp32_fn = capture_infer(fp32_fn, BATCH, size, device)

    t_int8 = time_fn(int8_fn, images)
    assert_fp32_highest()
    t_fp32 = time_fn(fp32_fn, images)

    img_s = BATCH / t_int8
    speedup = t_fp32 / t_int8
    print(f"int8 {img_s:.2f} images/s, fp32 {BATCH / t_fp32:.2f} images/s, speedup {speedup:.4f}",
          file=sys.stderr)
    result = {
        "metric": METRIC,
        "value": round(img_s, 2),
        "unit": "images/sec",
        "vs_baseline": round(speedup / REF_SPEEDUP, 4),
    }
    if not all(math.isfinite(result[k]) for k in ("value", "vs_baseline")):
        raise RuntimeError(f"non-finite result {result}")
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
