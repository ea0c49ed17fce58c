#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``ivit_tpu_torch``) on one NVIDIA GPU.

Drives the port's paths through ``deploy.engine.build_vit_infer`` at the
full width and depth of DeiT-S and through
``deploy.swin_engine.build_swin_infer`` at the full width and depth of
Swin-T, on seeded synthetic artifacts, and checks every hand-written
kernel on them:

* the main path: softmax_bits=8, stable ShiftGELU, K1 attention + K3
  LayerNorm (the default kernels);
* the reference-spec path: softmax_bits=16, row-max ShiftGELU, by three
  routes: A = K2 attention + K4 fc1-GEMM-with-GELU + K3; B = K6 Shiftmax
  into the base-256 split for the exact @V + K5 GELU + K3; and the K1 + K3 route as the
  check that all three give equal logits;
* the Swin-T serving path (``synthetic_swin_artifact("swin_tiny")``,
  row-max ShiftGELU as the JAX model defaults): K7 window attention + K3
  LayerNorm (the Swin engine's default kernels).

Phases:

1. the card's name and power limit (``nvidia-smi``);
2. builds the CUDA kernels from ``ivit_tpu_torch/csrc`` with nvcc, one
   process per source, all at once, and prints the registers and spill
   stack of K1's, K2's, K3's, K4's, K5's, K6's and K7's kernels and the
   tensor-core (IMMA) instructions of K4's and K7's (``cuobjdump``);
3. every kernel against its plain torch version, bit for bit
   (tolerance 0), at its path's batch-128 and batch-1 shapes, on the
   engine's own block-0 inputs and on random inputs that spread its
   values: K3 (25216, 384) / (197, 384); K1 and K2 (768, 197, 64) /
   (6, 197, 64) at out_bits 8 and 16, also on edge inputs (cells of equal
   scores, cells whose every score clips at -128 or +127 against
   V = -128, and a power-of-two 1/scale), one-token rows at a
   power-of-two 1/scale (probabilities 128 and 32768) at G = 768 and 6,
   and N in ATTN_N x hd in ATTN_HD on the edge inputs; K4 (25216, 384) x
   (384, 1536) / (197, ...), also on edge rows (all negative, tied at
   their max) and at a ragged (25211, 384) x (384, 1496), and its GELU
   tables on the card against their torch twin; K5 (25216, 1536) /
   (197, 1536), also on edge rows (all negative, at the int8 clip edges,
   tied at their max) at (25216, 1536), (33, 256), (5, 100) and (100,
   2048); K6 (151296, 197) / (1182, 197), also as a row-slice view
   (151295, 197) whose base lies 4 bytes past a 16-byte boundary, and on
   edge rows (uniform, all at -128, one-hot at 2^30) at N in K6_N with
   n_valid below and at N, M = 7 and 1182, out_bits 8 and 16, a spread
   scale and a power-of-two 1/scale (one-token rows: sm = 2^15, hi
   saturates to 127), from 16-byte aligned and offset bases; K7 at each
   Swin-T stage's (B·nW·H, 49, 32) shape, unshifted (block 0) and shifted with the window
   mask (block 1, stages 1-3), on the Swin path's own inputs and on random
   spread ones, and at every stage on edge inputs, unmasked, masked at a
   Swin-like scale and masked at a scale where masked arguments lie above
   the shift-exp clamp and masked scores are row maxima; K3 at Swin-T's
   norm inputs, (401408, 96) to (6272, 1536) and their batch-1 rows, and
   on edge rows (zero variance, alternating 32767 and -32768, values in
   +-60) at every path width with 16-byte and with scalar loads, and at
   the ragged and split-statistics widths 100, 33, 1000, 1001 and 8192;
   the engines on GEMM widths that are not multiples of 8 (a 100-class
   DeiT head, Swin at patch 2), on the card against the CPU;
4. each path at batch 128 and batch 1, with every launch count set to 0
   just before it and read just after: logits bit-equal to the plain ops
   on the card, to the plain engine on the CPU (first two images), batch
   1 equal to row 0 of batch 128, and the launches per forward stated
   (12 K1 + 25 K3; A: 12 K2 + 12 K4 + 25 K3; B: 12 K6 + 12 K5 + 25 K3;
   Swin-T: 12 K7 + 28 K3); at sm16, routes A, B and K1 give equal logits;
   the nonzero share of the 8-bit attention probabilities per block;
5. times (CUDA events after warm-up): each path's images/s at batch 128
   and ms/image at batch 1; each kernel (``ms``, launched as a caller
   launches it, and ``queued_ms``, its calls queued behind a spin kernel
   so that they run back to back) beside its plain version and, for
   K4, ``torch._int_mm`` on the same GEMM (a partial yardstick the port
   never calls); each kernel's bound (the larger of its bytes over the
   HBM rate and its operations over the peak rates; K1 and K2 count
   the per-score work of their shift-exp table, ATTN_TABLE_OPS, and K7,
   K4, K5 and K6 that of their tables, WINDOW_TABLE_OPS, GELU_TABLE_OPS,
   K5_TABLE_OPS and K6_TABLE_OPS, beside the counts of the chains they
   replace); K3
   summed over one batch-128 DeiT-S and Swin-T forward beside its summed
   bounds, and as the profiler reads it in those forwards; device
   time by kernel and the device's idle share over one profiled forward
   (torch.profiler): the main path, routes A and B and Swin-T at batch
   128, and route A at batch 1;
6. the serving entry points: each of the six paths of ``deploy.graphs``
   (main, A, B, the sm16 K1 route, Swin-T and ``kernels=()``) captured as
   a CUDA graph at batch 128 and 1, with every launch count set to 0
   just before the capture and read just after (the warm-up forwards and
   the capture; ``replay.launches`` the capture's alone, one forward's),
   replay logits bit-equal to the eager ones of phase 4, a replay adding
   no launch; batch-128 images/s graphed; batch-1 ms/image eager and
   graphed (host clock) and the idle share of one batch-1 forward each
   way; no host synchronisation inside one eager forward of each path;
   the benchmark's FP32 leg on the card with TF32 off against the CPU at
   batch 2 (FP32_RTOL; TF32 on must miss it), ``strict_dyadic`` at full
   DeiT-S width bit-equal to the CPU, a reference-style DeiT-S checkpoint
   through ``convert_model`` then the default kernels on the card
   bit-equal to the plain engine on the CPU (12 K1 + 25 K3); and
   ``python -m ivit_tpu_torch.bench`` (one JSON line with ``bench.py``'s
   keys) and ``python -m ivit_tpu_torch.evaluate_latency`` at batch 1
   (the main path, and ``--model swin_tiny``) run as a user runs them,
   each required to exit 0, their lines printed and their launches a
   forward checked.

Any failed check raises and exits nonzero before the result lines. The
second-to-last line is the kernels' JSON record, the last line
``{"ok": true, "device": {...}}``. Exits nonzero without a CUDA device
or without the package beside it.

Usage: ``python3 chip_smoke.py`` from the repository root (one card).
"""

from __future__ import annotations

import ast
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 0
BATCH = 128
ROUTE_A = ("layernorm", "attention2", "linear_gelu")
ROUTE_B = ("layernorm", "softmax", "gelu")
POW2_SCALE = 0.125  # 1/scale a power of two: a one-token row's probability is 2^(out_bits-1)
ATTN_N = (1, 17, 32, 33, 197, 256)  # K1/K2 edge shapes: tokens ...
ATTN_HD = (8, 32, 64, 128)          # ... against head widths
K6_N = (1, 5, 197, 256)             # K6 edge shapes: tokens a row
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaMemcpy")  # host calls that wait on the device
# the FP32 leg on the card against the CPU: relative to the largest |logit|
# (float32 products summed in other orders; TF32 rounds every product's
# inputs to 10 mantissa bits)
FP32_RTOL = 4e-6

# Published H100 SXM peaks (NVIDIA's data sheet, dense): HBM bytes/ms and
# int8 tensor-core ops/ms. 67 TFLOP/s in float32 counts an FMA as two
# operations: one float32 instruction per lane and clock is 33.5 T/s, and
# the chains have no FMA (-fmad=false). An SM has half as many int32 lanes
# as float32 ones (NVIDIA's H100 architecture paper), so 16.75 T/s int32.
HBM_PER_MS = 3.35e12 / 1e3
INT8_PER_MS = 1979e12 / 1e3
F32_PER_MS = 33.5e12 / 1e3
INT32_PER_MS = 16.75e12 / 1e3
# Elementwise instructions of each chain per element, counted from the
# kernels' source as (float32, int32); each add, mul, div, floor, rint,
# min, max and conversion is one, and loop-invariant terms are left out:
REQUANT_OPS = (4, 0)     # mul, rint, max, min
SHIFT_EXP_OPS = (17, 3)  # 2 x (div, floor), add, sub, max, div, floor, mul, 3 sub, mul, floor, 2 clip; exp2i
SHIFTMAX_OPS = (REQUANT_OPS[0] + 2 + SHIFT_EXP_OPS[0] + 2, SHIFT_EXP_OPS[1] + 1)  # max, sub; mul, floor; int sum
# K1 and K2 look the shift-exp up in a 256-entry table of the integer
# z - zmax (filled once per block), so per score the least work is the
# requant, the max, the multiply and the floor (float32) and the
# subtract, the lookup and the sum (int32)
ATTN_TABLE_OPS = (REQUANT_OPS[0] + 3, 3)
SPLIT_OPS = (7, 0)       # div, floor, mul, sub, sub, 2 x saturate
GELU_OPS = (2 * REQUANT_OPS[0] + 2 + SHIFT_EXP_OPS[0] + 9, SHIFT_EXP_OPS[1])  # max, sub; add, clip 2, div, floor, mul, div, floor, mul
LAYERNORM_OPS = (10, 10)  # int32 split statistics; convert, sub, mul, div, floor, add, requant
WINDOW_MERGE_OPS = (5, 0)  # K7's bias merge: mul, rint, add, max, min
MASK_OPS = (1, 0)          # K7's shifted-window mask add
# K7 since its tensor-core redesign looks rint(a8 * rb) up in a 256-entry
# table and the shift-exp in K1's table (plus a clamp entry), so per score
# the least work is the requant, the bias add, the clip, the max, the
# subtract, the multiply and the floor (float32) and two lookups and the
# sum (int32); the mask add stays MASK_OPS
WINDOW_TABLE_OPS = (REQUANT_OPS[0] + 7, 3)
# K4 since its redesign reads the whole GELU chain from a (q, max q)
# table: per element the int -> float step and the r1 requant (float32)
# and the bias add, the row max and the lookup (int32)
GELU_TABLE_OPS = (REQUANT_OPS[0] + 1, 3)
# K5 since its redesign reads the chain from the same table: per element
# the int -> float step and the r1 requant (float32) and the row max and
# the lookup (int32)
K5_TABLE_OPS = (REQUANT_OPS[0] + 1, 2)
# K6 since its redesign looks the shift-exp up in K1's table of the
# integral z - zmax and splits sm in integers: per score the int -> float
# step, the requant, the u32 -> float step, the multiply and the floor
# (float32), and the max, the subtract, the lookup, the sum and the
# split's shift, min, and and xor (int32)
K6_TABLE_OPS = (REQUANT_OPS[0] + 4, 8)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def cuda_ms(fn, iters: int, warmup: int = 3, queued: bool = False) -> float:
    """Mean device milliseconds per call, CUDA events around ``iters`` calls.
    ``queued`` first holds the stream in a spin kernel of about 0.1 ms a
    call, so that the host has queued the calls before the first runs: the
    events then time the kernels back to back, not the host's launch rate
    (a kernel of a few microseconds launches slower than it runs)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(iters * 200_000)  # clock cycles: about 0.1 ms a call
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def paired_ms(kernel_fn, plain_fn, iters: int) -> tuple[float, float, float]:
    """Kernel and plain times in the order plain, kernel, kernel, plain, and
    between the two kernel readings two of the kernel queued ahead of the
    device (``cuda_ms(queued=True)``): (kernel, plain, kernel queued)."""
    p1 = cuda_ms(plain_fn, iters)
    k1 = cuda_ms(kernel_fn, iters)
    q1 = cuda_ms(kernel_fn, iters, queued=True)
    q2 = cuda_ms(kernel_fn, iters, queued=True)
    k2 = cuda_ms(kernel_fn, iters)
    p2 = cuda_ms(plain_fn, iters)
    return (k1 + k2) / 2, (p1 + p2) / 2, (q1 + q2) / 2


def bound_ms(nbytes: float, int8_ops: float = 0.0, elementwise: tuple = (0.0, 0.0)) -> tuple[float, str]:
    """The least time the card could take: the larger of the bytes over
    the HBM rate and the operations of each unit over its peak rate
    (int8 tensor cores; float32 and int32 lanes, ``elementwise`` counts).
    The units run at the same time, so the largest of these times bounds."""
    t_bytes = nbytes / HBM_PER_MS
    t_ops = max(int8_ops / INT8_PER_MS, elementwise[0] / F32_PER_MS, elementwise[1] / INT32_PER_MS)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def per_element(n: int, *chains: tuple) -> tuple:
    """(float32, int32) operation counts of ``chains`` over n elements."""
    return (n * sum(c[0] for c in chains), n * sum(c[1] for c in chains))


def max_abs_err(a, b) -> int:
    return int((a.to(dtype=b.dtype).long() - b.long()).abs().max())


def reference_vit_state(a: dict) -> dict:
    """A reference-style DeiT QAT state dict (the ``weight_integer`` /
    ``bias_integer`` / ``*_scaling_factor`` buffers the ingester reads, as
    numpy arrays) holding the integers and scales of artifact ``a``."""
    import numpy as np

    f32 = np.float32
    p, D = a["config"]["patch_size"], a["config"]["embed_dim"]
    sd = {}

    def act(name, scale):
        sd[f"{name}.act_scaling_factor"] = np.array([scale], f32)

    def linear(prefix, layer, s_in):
        sd[f"{prefix}.weight_integer"] = layer["w"].T.astype(f32)
        sd[f"{prefix}.bias_integer"] = layer["b"].astype(f32)
        sd[f"{prefix}.fc_scaling_factor"] = (layer["out_scale"] / f32(s_in)).astype(f32)

    def norm(prefix, n):
        sd[f"{prefix}.bias_integer"], sd[f"{prefix}.norm_scaling_factor"] = n["bias_int"], n["out_scale"]

    pe = a["patch_embed"]
    act("qact_input", a["input_scale"])
    sd["patch_embed.proj.weight_integer"] = pe["w"].reshape(p, p, 3, D).transpose(3, 2, 0, 1).astype(f32)
    sd["patch_embed.proj.bias_integer"] = pe["b"].astype(f32)
    sd["patch_embed.proj.conv_scaling_factor"] = (pe["out_scale"] / f32(a["input_scale"])).astype(f32)
    act("patch_embed.qact", a["embed_scale"])
    sd["cls_token"] = (a["cls_q"] * a["embed_scale"]).astype(f32)
    act("qact_pos", a["pos_scale"])
    sd["pos_embed"] = (a["pos_q"] * a["pos_scale"]).astype(f32)
    act("qact1", a["tokens_scale"])
    for i, blk in enumerate(a["blocks"]):
        b = f"blocks.{i}"
        norm(f"{b}.norm1", blk["norm1"])
        act(f"{b}.qact1", blk["s_qact1"])
        linear(f"{b}.attn.qkv", blk["qkv"], blk["s_qact1"])
        for name, key in (("attn.qact1", "s_attn_qact1"), ("attn.qact_attn1", "s_attn_sm_in"), ("attn.qact2", "s_attn_out")):
            act(f"{b}.{name}", blk[key])
        linear(f"{b}.attn.proj", blk["proj"], blk["s_attn_out"])
        act(f"{b}.attn.qact3", blk["s_attn_proj"])
        act(f"{b}.qact2", blk["s_res1"])
        norm(f"{b}.norm2", blk["norm2"])
        act(f"{b}.qact3", blk["s_qact3"])
        linear(f"{b}.mlp.fc1", blk["fc1"], blk["s_qact3"])
        act(f"{b}.mlp.qact_gelu", blk["s_gelu_in"])
        act(f"{b}.mlp.qact1", blk["s_gelu_out"])
        linear(f"{b}.mlp.fc2", blk["fc2"], blk["s_gelu_out"])
        act(f"{b}.mlp.qact2", blk["s_mlp_out"])
        act(f"{b}.qact4", blk["s_res2"])
    norm("norm", a["norm"])
    act("qact2", a["head_in_scale"])
    linear("head", a["head"], a["head_in_scale"])
    return sd


def real_scale_artifact(a: dict) -> dict:
    """``a`` with its biases, class token and position embedding at the
    real values they stand for (the integers times their scales). The FP32
    benchmark leg feeds the raw integers (its timing does not depend on
    the values), under which its logits are the head's integer bias plus
    terms below that bias's float32 spacing; at real values the leg is a
    well-conditioned forward, on which TF32 shows."""
    import copy

    import numpy as np

    a = copy.deepcopy(a)
    for layer in [a["patch_embed"], a["head"]] + [blk[k] for blk in a["blocks"] for k in ("qkv", "proj", "fc1", "fc2")]:
        layer["b"] = (layer["b"].astype(np.float32) * layer["out_scale"]).astype(np.float32)
    a["pos_q"] = (a["pos_q"] * a["pos_scale"]).astype(np.float32)
    a["cls_q"] = (a["cls_q"] * a["embed_scale"]).astype(np.float32)
    return a


def run_cli(args: list, timeout: int) -> list:
    """Run ``python -m <args>`` from the repository root as a user would;
    print its output; fail unless it exits 0. Returns its stdout lines."""
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, "-m", *args], cwd=REPO, capture_output=True, text=True, timeout=timeout)
    print(f"cli python -m {' '.join(args)}: exit {run.returncode} in {time.perf_counter() - t0:.1f} s")
    for line in run.stdout.strip().splitlines():
        print(f"  stdout: {line}")
    for line in run.stderr.strip().splitlines()[-6:]:
        print(f"  stderr: {line}")
    check(run.returncode == 0, f"python -m {' '.join(args)} exited {run.returncode}")
    return run.stdout.strip().splitlines()


def main() -> int:
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(REPO, "ivit_tpu_torch")):
        print("chip_smoke: the ivit_tpu_torch package is not beside this script", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from ivit_tpu_torch import bench as port_bench
    from ivit_tpu_torch import convert_model
    from ivit_tpu_torch.deploy.engine import attention_half, attention_inputs, build_vit_infer, embed, int8_linear
    from ivit_tpu_torch.deploy.graphs import WARMUP, capture_infer
    from ivit_tpu_torch.deploy.swin_engine import (
        build_swin_infer,
        merge_gather,
        patch_embed,
        swin_trunk,
        window_attention_inputs,
    )
    from ivit_tpu_torch.deploy.swin_synthetic import swin_nonzero_probability_share, synthetic_swin_artifact
    from ivit_tpu_torch.deploy.synthetic import nonzero_probability_share, synthetic_vit_artifact
    from ivit_tpu_torch.kernels import (
        WRAPPERS,
        _build,
        fused_int8_attention,
        fused_int8_attention_reference,
        fused_int8_attention_v2,
        fused_int8_attention_v2_reference,
        fused_int8_window_attention,
        fused_int8_window_attention_reference,
        fused_layernorm_requant,
        fused_layernorm_requant_reference,
        fused_linear_shiftgelu,
        fused_linear_shiftgelu_reference,
        fused_requant_shiftgelu,
        fused_requant_shiftgelu_reference,
        fused_requant_shiftmax,
        fused_requant_shiftmax_reference,
    )
    from ivit_tpu_torch.kernels._gelu_common import gelu_table, gelu_table_on
    from ivit_tpu_torch.kernels.attention_fused import attention_probabilities
    from ivit_tpu_torch.kernels.attention_fused_v2 import scale_gate
    from ivit_tpu_torch.kernels.window_attention_fused import window_attention_probabilities
    from ivit_tpu_torch.models.swin import sw_attn_mask
    from ivit_tpu_torch.utils import load_artifact

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
    libs = _build.build(force=True)
    _build.load()
    print(f"build: nvcc {' '.join(_build.NVCC_FLAGS)}, {len(libs)} sources in parallel "
          f"-> {_build.BUILD_DIR} in {time.perf_counter() - t0:.3f} s")
    # registers, spill stack and static shared memory of the tensor-core
    # kernels, as built (they set how many blocks an SM holds), and the
    # IMMA (int8 tensor-core) instructions in the SASS of K4's and K7's
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    kernel_names = (
        ("K1", "attention_fused.cu", r"attention_mma_kernelILb(\d)ELb(\d)ELi(\d)E", "<kV2={}, out_bits 16={}, depth={}>"),
        ("K2", "attention_fused_v2.cu", r"attention_mma_kernelILb(\d)ELb(\d)ELi(\d)E", "<kV2={}, out_bits 16={}, depth={}>"),
        ("K3", "intnorm_fused.cu", r"fused_layernorm_requant_kernelILi(\d+)ELb(\d)E", "<G={}, vec={}>"),
        ("K4", "linear_gelu_fused.cu", r"(fused_linear_shiftgelu_kernel)ILi(\d)E|(gelu_table_kernel)", "{}"),
        ("K5", "shiftgelu_fused.cu", r"(fused_requant_shiftgelu_kernel)", "{}"),
        ("K6", "shiftmax_fused.cu", r"fused_requant_shiftmax_kernelILi(\d+)E", "<copy bytes={}>"),
        ("K7", "window_attention_fused.cu", r"window_attention_kernelILi(\d)ELi(\d+)ELb(\d)E", "<depth={}, key tiles={}, masked={}>"),
    )
    for name, source, pattern, form in kernel_names:
        lib = _build.lib_path(source)
        usage = subprocess.run([cuobjdump, "--dump-resource-usage", lib], capture_output=True, text=True,
                               check=True).stdout.splitlines()
        for fn, res in zip(usage, usage[1:]):
            args = re.search(pattern, fn)
            if args and "REG:" in res:
                label = form.format(*(a for a in args.groups() if a is not None))
                print(f"{name} resources: {label}: {' '.join(res.split()[:4])}")
        if name in ("K4", "K7"):
            imma, fn = {}, None
            for line in subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True,
                                       check=True).stdout.splitlines():
                if "Function :" in line:
                    fn = line.split("Function :")[1].strip()
                elif fn is not None and "IMMA" in line:
                    imma[fn] = imma.get(fn, 0) + 1
            for fn, count in sorted(imma.items()):
                args = re.search(pattern, fn)
                label = form.format(*(a for a in args.groups() if a is not None)) if args else fn
                print(f"{name} SASS: {label}: {count} IMMA instructions")
            check(len(imma) > 0, f"{name}: no IMMA instruction in {source}")

    # the paths' inputs
    t0 = time.perf_counter()
    art8 = synthetic_vit_artifact("deit_small", seed=SEED, softmax_bits=8, gelu_stable=True)
    art16 = synthetic_vit_artifact("deit_small", seed=SEED, softmax_bits=16, gelu_stable=False)
    cfg = art8["config"]
    print(f"artifacts: synthetic deit_small seed={SEED} {cfg} and softmax_bits=16 gelu_stable=False "
          f"in {time.perf_counter() - t0:.3f} s")
    rng = np.random.default_rng(SEED + 1)
    size = cfg["img_size"]
    images = torch.from_numpy(rng.standard_normal((BATCH, size, size, 3), dtype=np.float32))
    images_dev = images.to(dev)
    D, H, depth = cfg["embed_dim"], cfg["num_heads"], cfg["depth"]
    hd, N = D // H, (cfg["img_size"] // cfg["patch_size"]) ** 2 + 1
    hidden = int(D * cfg["mlp_ratio"])

    infer = build_vit_infer(art8, dev)  # the main path: the default kernels, K1 + K3
    routes16 = {
        "A": build_vit_infer(art16, dev, kernels=ROUTE_A),
        "B": build_vit_infer(art16, dev, kernels=ROUTE_B),
        "K1": build_vit_infer(art16, dev),
    }
    t0 = time.perf_counter()
    art_swin = synthetic_swin_artifact("swin_tiny", seed=SEED)
    scfg = art_swin["config"]
    print(f"artifact: synthetic swin_tiny seed={SEED} {scfg} in {time.perf_counter() - t0:.3f} s")
    swin = build_swin_infer(art_swin, dev)  # the Swin path: its default kernels, K7 + K3
    for name, r in [("main", infer), *routes16.items(), ("swin", swin)]:
        print(f"route {name}: kernels {sorted(r.kernels)}")
    scales = [b["attn"]["scale"] for b in routes16["A"].tensors["blocks"]]
    print(f"K2 gate N*ceil(1/scale)*2^15 < 2^31 at N={N}: softmax input scales {scales}, "
          f"all pass {all(scale_gate(N, s) for s in scales)}")

    # 3. kernels against their plain versions at the paths' shapes
    t8, t16 = infer.tensors, routes16["A"].tensors
    blk8, blk16 = t8["blocks"][0], t16["blocks"][0]
    with torch.inference_mode():
        x128, x1 = embed(images_dev, t8), embed(images_dev[:1], t8)
        x16 = {"b128": embed(images_dev, t16), "b1": embed(images_dev[:1], t16)}
    gen = torch.Generator().manual_seed(SEED)
    errs = {k: 0 for k in WRAPPERS}

    def compare(name: str, label: str, out, ref, quiet: bool = False) -> None:
        torch.cuda.synchronize()
        outs = out if isinstance(out, tuple) else (out,)
        refs = ref if isinstance(ref, tuple) else (ref,)
        err = max(max_abs_err(o, r) for o, r in zip(outs, refs))
        errs[name] = max(errs[name], err)
        if not quiet:
            distinct = int(refs[0].unique().numel())
            print(f"{name} {label}: max_abs_err {err} (tolerance 0), distinct outputs {distinct}")
        check(err == 0, f"{name} {label} differs from its plain version")

    k3_cases = {f"({BATCH * N}, {D})": x128.reshape(-1, D), f"({N}, {D})": x1.reshape(-1, D),
                f"({BATCH}, {D}) final norm": x128[:, 0].contiguous()}
    for shape, x in k3_cases.items():
        args = (x, blk8["norm1"]["bias_int"], blk8["norm1"]["ratio"])
        compare("K3", shape, fused_layernorm_requant(*args), fused_layernorm_requant_reference(*args))

    # K1 and K2: the block-0 q, k, v of each path, random spread inputs and
    # edge inputs
    s8 = {k: np.float32(art8["blocks"][0][k]) for k in ("s_attn_qact1", "s_attn_out")}
    spread_r1 = float(np.float32(127.0 / (3 * np.sqrt(hd) * 74.0**2)))
    spread_scale = float(np.float32(0.07))

    def r_out_at(bits: int) -> float:
        """The main path's block-0 r_out at this probability width (f32, as the engine forms it)."""
        return float(np.float32(np.float32(1.0 / 2 ** (bits - 1)) * s8["s_attn_qact1"]) / s8["s_attn_out"])

    def edge_inputs(G: int, n_tok: int, d: int) -> list:
        """Random int8 q, k, v whose first cells hold the edges: equal
        scores (q = 0), and every score clipped at -128 or at +127 against
        V = -128 (the largest |context|)."""
        q, k, v = (torch.randint(-128, 128, (G, n_tok, d), generator=gen, dtype=torch.int8) for _ in range(3))
        c = max(G // 4, 1)
        q[:c] = 0
        q[c:2 * c], k[c:2 * c], v[c:2 * c] = 127, -128, -128
        q[2 * c:3 * c], k[2 * c:3 * c], v[2 * c:3 * c] = 127, 127, -128
        return [t.to(dev) for t in (q, k, v)]

    def compare_attention(q, k, v, r1, scale, r_out, bits, data, quiet=False) -> None:
        n_tok = q.shape[1]
        label = f"({', '.join(map(str, q.shape))}) out_bits={bits} {data}"
        if not quiet:
            probs = attention_probabilities(q, k, r1, scale, bits)
            label += f", nonzero probabilities {float((probs > 0).float().mean())}"
        compare("K1", label, fused_int8_attention(q, k, v, r1, scale, r_out, bits),
                fused_int8_attention_reference(q, k, v, r1, scale, r_out, bits), quiet)
        if scale_gate(n_tok, scale):
            compare("K2", label, fused_int8_attention_v2(q, k, v, r1, scale, r_out, n_tok, bits),
                    fused_int8_attention_v2_reference(q, k, v, r1, scale, r_out, n_tok, bits), quiet)

    attn_inputs = {}
    for size, xa, xb in (("b128", x128, x16["b128"]), ("b1", x1, x16["b1"])):
        with torch.inference_mode():
            attn_inputs[size] = {"sm8": attention_inputs(xa, blk8, H), "sm16": attention_inputs(xb, blk16, H)}
    for size, ins in attn_inputs.items():
        q8, k8, v8 = ins["sm8"]
        G = q8.shape[0]
        rand = [torch.randint(-128, 128, (G, N, hd), generator=gen, dtype=torch.int8).to(dev) for _ in range(3)]
        edges = edge_inputs(G, N, hd)
        for bits in (8, 16):
            r_out8 = r_out_at(bits)
            a16 = blk16["attn"]
            cases = [
                ("main-path block0", ins["sm8"], blk8["attn"]["r1"], blk8["attn"]["scale"], r_out8),
                ("random", rand, spread_r1, spread_scale, r_out8),
            ]
            if bits == 16:
                cases.insert(1, ("sm16 block0", ins["sm16"], a16["r1"], a16["scale"], a16["r_out"]))
            cases += [("edges", edges, spread_r1, spread_scale, r_out8),
                      ("edges, power-of-two 1/scale", edges, spread_r1, POW2_SCALE, r_out8)]
            for data, (qq, kk, vv), r1, scale, r_out in cases:
                compare_attention(qq, kk, vv, r1, scale, r_out, bits, data)
    # one-token rows at a power-of-two 1/scale (probability 2^(out_bits-1)),
    # at the paths' cell counts, and every N in ATTN_N against every hd in
    # ATTN_HD, each on the edge inputs
    for G in (BATCH * H, H):
        for bits in (8, 16):
            qq, kk, vv = edge_inputs(G, 1, hd)
            probs = attention_probabilities(qq, kk, spread_r1, POW2_SCALE, bits)
            check(float(probs.max()) == 2.0 ** (bits - 1), f"one-token rows: probability {float(probs.max())}")
            compare_attention(qq, kk, vv, spread_r1, POW2_SCALE, r_out_at(bits), bits, "one-token rows")
    for n_tok in ATTN_N:
        for hd_ in ATTN_HD:
            qq, kk, vv = edge_inputs(5, n_tok, hd_)
            r1 = float(np.float32(127.0 / (3 * np.sqrt(hd_) * 74.0**2)))
            for bits in (8, 16):
                for scale in (spread_scale, POW2_SCALE):
                    compare_attention(qq, kk, vv, r1, scale, r_out_at(bits), bits, f"edges scale {scale}", quiet=True)
    print(f"K1, K2: max_abs_err 0 (tolerance 0) at N in {ATTN_N} x hd in {ATTN_HD} (G = 5) on the edge inputs, "
          f"out_bits 8 and 16, scales {spread_scale} and {POW2_SCALE}")

    # K6: the block-0 scores of the sm16 path and random spread scores
    def scores(q, k):
        return torch.matmul(q.double(), k.double().transpose(-1, -2)).to(torch.int32).reshape(-1, N)

    k6_inputs = {}
    for size, ins in attn_inputs.items():
        q16, k16, _ = ins["sm16"]
        G = q16.shape[0]
        rq, rk = (torch.randint(-128, 128, (G, N, hd), generator=gen, dtype=torch.int8).to(dev) for _ in range(2))
        a16 = blk16["attn"]
        k6_inputs[size] = (scores(q16, k16), a16["r1"], a16["scale"])
        for data, (x, r1, scale) in (("sm16 block0", k6_inputs[size]), ("random", (scores(rq, rk), spread_r1, spread_scale))):
            compare("K6", f"({x.shape[0]}, {N}) {data}", fused_requant_shiftmax(x, r1, scale, N),
                    fused_requant_shiftmax_reference(x, r1, scale, N))
    # the block-0 scores from a row-slice view: the base 4 bytes past a
    # 16-byte boundary (the kernel's 4-byte copies), M not a multiple of
    # the 16-row tile
    x, r1, scale = k6_inputs["b128"]
    check(x[1:].data_ptr() % 16 == 4, f"row-slice view at {x[1:].data_ptr() % 16} bytes past 16")
    compare("K6", f"({x.shape[0] - 1}, {N}) sm16 block0 row-slice view", fused_requant_shiftmax(x[1:], r1, scale, N),
            fused_requant_shiftmax_reference(x[1:], r1, scale, N))

    # K6 on edge rows (uniform: x = 0; all valid at -128: x = -2^30; one-hot:
    # 2^30 in column 0), spread rows elsewhere, at N in K6_N with n_valid
    # below N and at N, out_bits 8 and 16, a spread scale and a power-of-two
    # 1/scale (one-token rows: sm = 2^15 and hi saturates to 127), M = 7 and
    # 1182, from a 16-byte aligned base and from one 4 bytes past
    k6_r1 = float(np.float32(100.0 / 2**20))  # the spread rows span the int8 clip
    saturated = 0
    for n_tok in K6_N:
        for M in (7, H * N):
            ex = torch.randint(-(2**20), 2**20, (M, n_tok), generator=gen, dtype=torch.int32)
            ex[0], ex[1], ex[2, 0] = 0, -(2**30), 2**30
            buf = torch.empty(M * n_tok + 1, dtype=torch.int32, device=dev)
            buf[1:] = ex.reshape(-1).to(dev)
            bases = {"aligned": ex.to(dev), "offset": buf[1:].view(M, n_tok)}
            check(bases["offset"].data_ptr() % 16 == 4, "K6 edges: offset base")
            for n_valid in sorted({n_tok, (n_tok + 1) // 2, 1}):
                for bits in (8, 16):
                    for scale in (spread_scale, POW2_SCALE):
                        for base, xe in bases.items():
                            ref = fused_requant_shiftmax_reference(xe, k6_r1, scale, n_valid, bits)
                            if n_valid == 1 and scale == POW2_SCALE and bits == 16:  # sm = 2^15 in column 0
                                check(bool((ref[0][:, 0] == 127).all() and (ref[1][:, 0] == -128).all()),
                                      "K6 edges: a one-token row's hi did not saturate")
                                saturated += M
                            compare("K6", f"edges ({M}, {n_tok}) n_valid={n_valid} out_bits={bits} scale={scale} {base}",
                                    fused_requant_shiftmax(xe, k6_r1, scale, n_valid, bits), ref, quiet=True)
    print(f"K6: max_abs_err 0 (tolerance 0) on edge rows at N in {K6_N}, n_valid below and at N, out_bits 8 and 16, "
          f"scales {spread_scale} and {POW2_SCALE}, M = 7 and 1182, aligned and offset bases; {saturated} one-token rows "
          "with hi saturated to 127")

    # K4 and K5: the block-0 MLP inputs of the sm16 path, and random inputs
    # whose per-channel ratios spread the GELU inputs over int8
    fc1, gelu = blk16["fc1"], blk16["gelu"]
    gelu_args = (gelu["s_in"], gelu["r2"])
    k4_inputs, k5_inputs = {}, {}
    for size, xs in x16.items():
        with torch.inference_mode():
            y = fused_layernorm_requant_reference(attention_half(xs, blk16, t16["config"], ()),
                                                  blk16["norm2"]["bias_int"], blk16["norm2"]["ratio"])
            acc = int8_linear(y, fc1)
        M = y.shape[0]
        k4_inputs[size] = (y, fc1["w_t"].T, fc1["b"], fc1["ratio"], *gelu_args)
        k5_inputs[size] = (acc, fc1["ratio"], *gelu_args)
        ry = torch.randint(-128, 128, (M, D), generator=gen, dtype=torch.int8).to(dev)
        spread = torch.from_numpy((np.random.default_rng(M).uniform(0.5, 2.0, hidden)).astype(np.float32)).to(dev)
        r1_gemm = spread * float(40.0 / (74.0**2 * np.sqrt(D)))
        racc = torch.randint(-(2**20), 2**20, (M, hidden), generator=gen, dtype=torch.int32).to(dev)
        racc[0] = -racc[0].abs() - 1  # an all-negative row: e_max saturates
        for data, args in (("sm16 block0", k4_inputs[size]), ("random", (ry, fc1["w_t"].T, fc1["b"], r1_gemm, *gelu_args))):
            compare("K4", f"({M}, {D}) x ({D}, {hidden}) {data}", fused_linear_shiftgelu(*args),
                    fused_linear_shiftgelu_reference(*args))
        for data, args in (("sm16 block0", k5_inputs[size]), ("random", (racc, spread * 1e-4, *gelu_args))):
            compare("K5", f"({M}, {hidden}) {data}", fused_requant_shiftgelu(*args),
                    fused_requant_shiftgelu_reference(*args))

    # K4 on edge rows (row 0 all negative: x = 0 against a negative bias,
    # e_max saturates; row 1 tied at its max: x = 127 against 16 weight
    # columns of 127, which clip) at the path's shapes and at an M and a C
    # that are not multiples of the 64-row blocks and 256-column chunks,
    # and the GELU tables the card filled against their torch twin
    def k4_edges(M: int, C: int) -> tuple:
        ex = torch.randint(-128, 128, (M, D), generator=gen, dtype=torch.int8)
        ew = torch.randint(-128, 128, (C, D), generator=gen, dtype=torch.int8)
        eb = torch.randint(-(2**15), -(2**14), (C,), generator=gen, dtype=torch.int32)
        ex[0], ex[1], ew[:16] = 0, 127, 127
        er1 = torch.from_numpy((np.random.default_rng(C).uniform(0.5, 2.0, C) * 40.0 / (74.0**2 * np.sqrt(D))).astype(np.float32))
        return ex.to(dev), ew.to(dev).T, eb.to(dev), er1.to(dev), *gelu_args

    for M, C in ((BATCH * N, hidden), (N, hidden), (BATCH * N - 5, hidden - 40)):
        args = k4_edges(M, C)
        ref = fused_linear_shiftgelu_reference(*args)
        check(bool((ref[0] <= 0).all()), "K4 edges: row 0 is not all negative")
        compare("K4", f"({M}, {D}) x ({D}, {C}) edge rows", fused_linear_shiftgelu(*args), ref)
    gelu_pairs = sorted({(b["gelu"]["s_in"], b["gelu"]["r2"]) for b in t16["blocks"]})
    for s_in, r2 in gelu_pairs:
        compare("K4", f"GELU table s_in={s_in} r2={r2}", gelu_table_on(dev, s_in, r2), gelu_table(s_in, r2).to(dev),
                quiet=True)
    print(f"K4 GELU tables of the {len(gelu_pairs)} (s_in, r2) of route A: equal to their torch twin "
          "(tolerance 0)")

    # K5 on edge rows: all negative (e_max saturates), +127 / -128
    # alternating, all -128, tied at a max of +127 (every fifth channel
    # clips), spread rows elsewhere; at route B's shape, small and ragged
    # ones and a width past the 1,536 channels a lane keeps
    for M, C in ((BATCH * N, hidden), (33, 256), (5, 100), (100, 2048)):
        ex = torch.randint(-(2**20), 2**20, (M, C), generator=gen, dtype=torch.int32)
        ex[0] = -ex[0].abs() - 2**15 - 1
        ex[1, ::2], ex[1, 1::2] = 2**30, -(2**30)
        ex[2] = -(2**30)
        ex[3, ::5] = 2**30
        er1 = torch.from_numpy((np.random.default_rng(C).uniform(0.5, 2.0, C) * 1e-4).astype(np.float32))
        args = (ex.to(dev), er1.to(dev), *gelu_args)
        ref = fused_requant_shiftgelu_reference(*args)
        check(bool((ref[0] <= 0).all()), "K5 edges: row 0 is not all negative")
        compare("K5", f"({M}, {C}) edge rows", fused_requant_shiftgelu(*args), ref)

    # K7 and K3 on the Swin path's own inputs at batch 128 and batch 1:
    # each stage's block 0 (unshifted) and block 1 (shifted, masked in
    # stages 1-3) window q, k, v, and the norm inputs of each stage's
    # first block and of each patch merging
    ts = swin.tensors
    where = {}
    for i, st in enumerate(ts["stages"]):
        where.update({id(b): (i, j) for j, b in enumerate(st["blocks"])})
        if "downsample" in st:
            where[id(st["downsample"])] = (i, "merge")
    window_inputs, swin_norm_inputs = {}, {}
    for size, imgs in (("b128", images_dev), ("b1", images_dev[:1])):
        def visit(layer, x, size=size):
            i, j = where[id(layer)]
            if j == "merge":
                swin_norm_inputs[(size, f"merge {i + 1}")] = (merge_gather(x, layer["res"]), layer["norm"])
                return
            if j == 0:
                swin_norm_inputs[(size, f"stage {i + 1}")] = (x.reshape(-1, x.shape[-1]), layer["norm1"])
            if j < 2:
                window_inputs[(size, i, j)] = (layer, window_attention_inputs(x, layer, kernels=()))

        with torch.inference_mode():
            swin_trunk(patch_embed(imgs, ts), ts, (), on_layer=visit)
    for (size, label), (x, norm) in swin_norm_inputs.items():
        args = (x, norm["bias_int"], norm["ratio"])
        compare("K3", f"Swin-T {label} {tuple(x.shape)}", fused_layernorm_requant(*args),
                fused_layernorm_requant_reference(*args))

    # K3 on edge rows at every path width and its batch-128 row count:
    # zero variance (at 3 and at -32768), alternating 32767 and -32768,
    # values in +-60, spread rows elsewhere; with 16-byte loads and, from
    # a base 2 bytes past a 16-byte boundary, the scalar instantiation;
    # then the ragged widths and the split statistics (C > 1000)
    def k3_edges(M: int, C: int, offset: int = 0) -> tuple:
        x = torch.randint(-(2**15), 2**15, (M, C), generator=gen, dtype=torch.int16)
        x[0], x[1] = 3, -(2**15)
        x[2, ::2], x[2, 1::2] = 32767, -32768
        x[3] = torch.randint(-60, 61, (C,), generator=gen, dtype=torch.int16)
        buf = torch.empty(M * C + offset, dtype=torch.int16, device=dev)
        buf[offset:] = x.reshape(-1).to(dev)
        rng_c = np.random.default_rng(C)
        bias = torch.from_numpy(np.floor(rng_c.standard_normal(C) * 2**24).astype(np.float32)).to(dev)
        ratio = torch.from_numpy((rng_c.uniform(0.5, 2.0, C) * np.sqrt(C) * 2.0**-25).astype(np.float32)).to(dev)
        return buf[offset:].view(M, C), bias, ratio

    k3_widths = {96: 401408, 192: 100352, 384: BATCH * N, 768: 25088, 1536: 6272}
    for C, M in k3_widths.items():
        for offset in (0, 1):
            args = k3_edges(M if offset == 0 else M // 8 + 3, C, offset)
            compare("K3", f"edges ({args[0].shape[0]}, {C}) {'scalar' if offset else '16-byte'} loads",
                    fused_layernorm_requant(*args), fused_layernorm_requant_reference(*args), quiet=True)
    for M, C in ((1003, 100), (1003, 33), (517, 1000), (517, 1001), (67, 8192)):
        args = k3_edges(M, C)
        compare("K3", f"edges ({M}, {C})", fused_layernorm_requant(*args), fused_layernorm_requant_reference(*args),
                quiet=True)
    print(f"K3: max_abs_err 0 (tolerance 0) on edge rows at C in {tuple(k3_widths)} with 16-byte and scalar "
          "loads, and at (1003, 100), (1003, 33), (517, 1000), (517, 1001), (67, 8192)")
    spread_r1_w = float(np.float32(127.0 / (3 * np.sqrt(32) * 74.0**2)))

    def window_shape(q, a) -> str:
        return f"({', '.join(map(str, q.shape))}) {'masked' if a['mask'] is not None else 'unmasked'}"

    for (size, i, j), (blk, (q, k, v)) in window_inputs.items():
        a, heads = blk["attn"], blk["heads"]
        rand = [torch.randint(-128, 128, q.shape, generator=gen, dtype=torch.int8).to(dev) for _ in range(3)]
        for data, (qq, kk, vv), r1 in (("Swin-T block inputs", (q, k, v), a["r1"]), ("random", rand, spread_r1_w)):
            args = (qq, kk, vv, a["bias"], a["mask"], r1, a["rb"], a["scale"], a["r_out"], heads)
            probs = window_attention_probabilities(qq, kk, a["bias"], a["mask"], r1, a["rb"], a["scale"], heads)
            label = (f"stage {i + 1} block {j} {window_shape(q, a)} {data}, "
                     f"nonzero probabilities {float((probs > 0).float().mean())}")
            compare("K7", label, fused_int8_window_attention(*args), fused_int8_window_attention_reference(*args))

    # K7 at every Swin-T stage shape, batch 128 and 1, on edge inputs:
    # spread q, k, v with cells of tied scores (q = 0) and of clipped ones
    # (q = 127, k = -128), an integer bias, unmasked; masked with the
    # stage's shifted-window plane (stage 4's from the 7 x 7 geometry) at
    # a Swin-like scale, where every masked argument lies at or below the
    # shift-exp clamp; and at s_bias = 0.45, where the rows of window 0
    # that have a masked column get bias 127 there and -100 or -300
    # elsewhere: masked arguments above the clamp take the chain, and
    # masked scores become row maxima
    for (size, i, j), (blk, (q, _, _)) in window_inputs.items():
        if j != 0:
            continue
        (G, Nw, hdw), heads, res, ws = q.shape, blk["heads"], blk["res"], blk["ws"]
        plane = sw_attn_mask(res, res, ws, max(ws // 2, 1))
        qq, kk, vv = (torch.randint(-128, 128, (G, Nw, hdw), generator=gen, dtype=torch.int8) for _ in range(3))
        c = max(G // 8, 1)
        qq[:c] = 0
        qq[c:2 * c], kk[c:2 * c] = 127, -128
        qq, kk, vv = qq.to(dev), kk.to(dev), vv.to(dev)
        for label, scale, low in (("unmasked", 0.07, None), ("masked", 0.07, None),
                                  ("masked above the clamp", 0.45, -100.0), ("masked row maxima", 0.45, -300.0)):
            scale = float(np.float32(scale))
            bias = torch.randint(-30, 31, (heads, Nw, Nw), generator=gen).float()
            if low is not None:
                hit = torch.from_numpy(plane[0] != 0)
                bias[:] = torch.where(hit, 127.0, torch.where(hit.any(-1, keepdim=True), low, bias))
            mask = None if label == "unmasked" else torch.from_numpy(plane / np.float32(scale)).to(dev)
            args = (qq, kk, vv, bias.to(dev), mask, spread_r1_w, float(np.float32(0.9)), scale,
                    float(np.float32(0.05 / 128 / 0.021)), heads)
            compare("K7", f"stage {i + 1} {size} ({G}, {Nw}, {hdw}) edges, {label}, s_bias {scale}",
                    fused_int8_window_attention(*args), fused_int8_window_attention_reference(*args), quiet=True)
    print("K7: max_abs_err 0 (tolerance 0) at every Swin-T stage shape, batch 128 and 1, on edge inputs: "
          "unmasked, masked at s_bias 0.07, masked arguments above the clamp and masked row maxima at 0.45")

    # GEMM widths that are not multiples of 8: a 100-class DeiT head (N =
    # 100) and Swin at patch 2 (a patch-embed K of 12), through the
    # zero-padded weights of carry_linear, on the card against the plain
    # engine on the CPU
    odd_widths = {
        "DeiT num_classes=100": (build_vit_infer, 32, synthetic_vit_artifact(
            "deit_tiny", seed=SEED, img_size=32, patch_size=8, embed_dim=128, depth=2, num_heads=2,
            num_classes=100)),
        "Swin patch_size=2": (build_swin_infer, 16, synthetic_swin_artifact(
            "swin_tiny", seed=SEED, img_size=16, patch_size=2, embed_dim=16, depths=(2, 2), num_heads=(2, 4),
            window_size=4, num_classes=8)),
    }
    for label, (build, side, art) in odd_widths.items():
        w_odd = art["head" if build is build_vit_infer else "patch_embed"]["w"]
        try:
            torch._int_mm(torch.zeros((1024, w_odd.shape[0]), dtype=torch.int8, device=dev), torch.from_numpy(w_odd).to(dev))
            refusal = "takes it"
        except RuntimeError as e:
            refusal = f"raises {str(e).splitlines()[0]!r}"
        print(f"widths {label}: torch._int_mm on the unpadded {tuple(w_odd.shape)} weight {refusal}")
        imgs = torch.from_numpy(rng.standard_normal((3, side, side, 3), dtype=np.float32))
        cpu_logits = build(art, "cpu", kernels=())(imgs)
        for kernels in ("default", ()):
            fn = build(art, dev) if kernels == "default" else build(art, dev, kernels=kernels)
            logits_odd = fn(imgs.to(dev)).cpu()
            e_odd = float((logits_odd - cpu_logits).abs().max())
            print(f"widths {label}, kernels {sorted(fn.kernels)}: logits {tuple(logits_odd.shape)} vs the plain "
                  f"engine on the CPU: max_abs_err {e_odd} (tolerance 0)")
            check(torch.equal(logits_odd, cpu_logits), f"widths {label}: differs from the CPU plain engine")

    # 4. each path end to end, its launch counts read around its own run
    def drive(name: str, fn, expect: dict) -> tuple:
        for w in WRAPPERS.values():
            w.launches = 0
        out128 = fn(images_dev)
        out1 = fn(images_dev[:1])
        torch.cuda.synchronize()
        counts = {k: w.launches for k, w in WRAPPERS.items()}
        print(f"route {name}: launches over 2 forwards (batch {BATCH}, batch 1): {counts}")
        for k, per_forward in expect.items():
            check(counts[k] == 2 * per_forward, f"route {name}: {k} launched {counts[k]} times, expected {2 * per_forward}")
        check(sum(counts.values()) == 2 * sum(expect.values()), f"route {name}: unexpected launches {counts}")
        check(tuple(out128.shape) == (BATCH, cfg["num_classes"]), f"logits shape {tuple(out128.shape)}")
        check(bool(torch.isfinite(out128).all()), f"route {name}: non-finite logits")
        e_b1 = float((out1 - out128[:1]).abs().max())
        print(f"route {name}: logits batch 1 vs row 0 of batch {BATCH}: max_abs_err {e_b1} (tolerance 0)")
        check(torch.equal(out1, out128[:1]), f"route {name}: batch 1 differs from row 0 of the batch")
        return out128, counts

    def against_plain(name: str, logits, plain, cpu2) -> None:
        e_plain = float((logits - plain).abs().max())
        e_cpu = float((logits[:2].cpu() - cpu2).abs().max())
        print(f"route {name}: logits vs plain ops on the card: max_abs_err {e_plain}; "
              f"rows 0-1 vs plain engine on the CPU: max_abs_err {e_cpu} (tolerance 0)")
        check(torch.equal(logits, plain), f"route {name}: differs from the plain ops on the card")
        check(torch.equal(logits[:2].cpu(), cpu2), f"route {name}: differs from the CPU plain engine")

    layernorms = 2 * depth + 1
    logits, main_counts = drive("main", infer, {"K1": depth, "K3": layernorms})
    plain8 = build_vit_infer(art8, dev, kernels=())
    against_plain("main", logits, plain8(images_dev), build_vit_infer(art8, "cpu", kernels=())(images[:2]))
    shares = nonzero_probability_share(art8, images[:8], dev)
    print(f"non-degeneracy (main path): nonzero attention probabilities per block {shares}; "
          f"distinct argmax over {BATCH} images {int(logits.argmax(-1).unique().numel())}; "
          f"logit std {float(logits.std())}")

    plain16 = build_vit_infer(art16, dev, kernels=())
    plain16_logits = plain16(images_dev)
    cpu16 = build_vit_infer(art16, "cpu", kernels=())(images[:2])
    expects = {"A": {"K2": depth, "K4": depth, "K3": layernorms},
               "B": {"K6": depth, "K5": depth, "K3": layernorms},
               "K1": {"K1": depth, "K3": layernorms}}
    route_logits, route_counts = {}, {}
    for name, r in routes16.items():
        route_logits[name], route_counts[name] = drive(name, r, expects[name])
        against_plain(name, route_logits[name], plain16_logits, cpu16)
    check(torch.equal(route_logits["A"], route_logits["B"]) and torch.equal(route_logits["A"], route_logits["K1"]),
          "sm16 routes A, B and K1 disagree")
    shares16 = nonzero_probability_share(art16, images[:8], dev)
    print(f"sm16 routes A, B, K1: equal logits; nonzero attention probabilities per block {shares16}; "
          f"distinct argmax over {BATCH} images {int(route_logits['A'].argmax(-1).unique().numel())}; "
          f"logit std {float(route_logits['A'].std())}")

    swin_blocks = sum(scfg["depths"])
    swin_norms = 2 * swin_blocks + len(scfg["depths"])  # two per block, one per merging, the final norm
    swin_logits, swin_counts = drive("swin", swin, {"K7": swin_blocks, "K3": swin_norms})
    swin_plain = build_swin_infer(art_swin, dev, kernels=())
    against_plain("swin", swin_logits, swin_plain(images_dev), build_swin_infer(art_swin, "cpu", kernels=())(images[:2]))
    shares_swin = swin_nonzero_probability_share(art_swin, images[:8], dev)
    print(f"non-degeneracy (swin): nonzero 8-bit window attention probabilities per block {shares_swin}; "
          f"distinct argmax over {BATCH} images {int(swin_logits.argmax(-1).unique().numel())}; "
          f"logit std {float(swin_logits.std())}")

    # 5. timing
    def engine_times(name: str, fn, plain_fn=None) -> None:
        ms128 = cuda_ms(lambda: fn(images_dev), 10)
        line = f"engine {name} batch {BATCH}: {ms128} ms/forward, {BATCH / ms128 * 1e3} images/s"
        if plain_fn is not None:
            p = cuda_ms(lambda: plain_fn(images_dev), 5)
            line += f" (plain ops: {p} ms, {BATCH / p * 1e3} images/s)"
        print(line)
        lat = []
        for i in range(60):
            t1 = time.perf_counter()
            fn(images_dev[:1])
            torch.cuda.synchronize()
            if i >= 10:
                lat.append((time.perf_counter() - t1) * 1e3)
        lat.sort()
        print(f"engine {name} batch 1: median {lat[len(lat) // 2]} ms/image, min {lat[0]}, max {lat[-1]} "
              f"(host clock, {len(lat)} runs); device {cuda_ms(lambda: fn(images_dev[:1]), 50)} ms/forward")

    engine_times("main (sm8, K1+K3)", infer, plain8)
    engine_times("A (sm16, K2+K4+K3)", routes16["A"], plain16)
    engine_times("B (sm16, K6+K5+K3)", routes16["B"])
    engine_times("K1 (sm16, K1+K3)", routes16["K1"])
    engine_times("swin (Swin-T, K7+K3)", swin, swin_plain)

    timings, bounds = {}, {}
    chain_bounds = {}  # K4's, K5's, K6's and K7's bounds by the counts of the chains their tables replace
    for shape, x in k3_cases.items():
        args = (x, blk8["norm1"]["bias_int"], blk8["norm1"]["ratio"])
        timings[("K3", shape)] = paired_ms(lambda: fused_layernorm_requant(*args),
                                           lambda: fused_layernorm_requant_reference(*args), 20)
        M = x.shape[0]
        bounds[("K3", shape)] = bound_ms(M * D * 3 + 8 * D, elementwise=per_element(M * D, LAYERNORM_OPS))
    for size, ins in attn_inputs.items():
        for name, (q, k, v), a, bits, fn, ref in (
            ("K1", ins["sm8"], blk8["attn"], 8, fused_int8_attention, fused_int8_attention_reference),
            ("K2", ins["sm16"], blk16["attn"], 16, fused_int8_attention_v2, fused_int8_attention_v2_reference),
        ):
            args = (q, k, v, a["r1"], a["scale"], a["r_out"]) + ((N,) if name == "K2" else ()) + (bits,)
            shape = f"({q.shape[0]}, {N}, {hd})"
            timings[(name, shape)] = paired_ms(lambda: fn(*args), lambda: ref(*args), 20)
            G = q.shape[0]
            pv_products = 1 if bits == 8 else 2  # 16-bit probabilities: two int8 products
            bounds[(name, shape)] = bound_ms(4 * G * N * hd, int8_ops=2 * G * N * N * hd * (1 + pv_products),
                                             elementwise=per_element(G * N * N, ATTN_TABLE_OPS))
    for (size, label), (x, norm) in swin_norm_inputs.items():
        args = (x, norm["bias_int"], norm["ratio"])
        shape = f"{tuple(x.shape)} Swin-T {label}"
        timings[("K3", shape)] = paired_ms(lambda: fused_layernorm_requant(*args),
                                           lambda: fused_layernorm_requant_reference(*args), 20)
        M, C = x.shape
        bounds[("K3", shape)] = bound_ms(M * C * 3 + 8 * C, elementwise=per_element(M * C, LAYERNORM_OPS))
    for (size, i, j), (blk, (q, k, v)) in window_inputs.items():
        if j != (0 if i == len(scfg["depths"]) - 1 else 1):
            continue  # one block a stage: the masked one where the stage shifts
        a, heads = blk["attn"], blk["heads"]
        args = (q, k, v, a["bias"], a["mask"], a["r1"], a["rb"], a["scale"], a["r_out"], heads)
        shape = window_shape(q, a)
        timings[("K7", shape)] = paired_ms(lambda: fused_int8_window_attention(*args),
                                           lambda: fused_int8_window_attention_reference(*args), 20)
        G, Nw, hdw = q.shape
        planes = heads + (0 if a["mask"] is None else a["mask"].shape[0])
        mask_ops = (MASK_OPS,) if a["mask"] is not None else ()
        nbytes, products = 4 * G * Nw * hdw + 4 * planes * Nw * Nw, 4 * G * Nw * Nw * hdw
        bounds[("K7", shape)] = bound_ms(nbytes, int8_ops=products,
                                         elementwise=per_element(G * Nw * Nw, WINDOW_TABLE_OPS, *mask_ops))
        chain_bounds[("K7", shape)] = bound_ms(nbytes, int8_ops=products,
                                               elementwise=per_element(G * Nw * Nw, SHIFTMAX_OPS, WINDOW_MERGE_OPS, *mask_ops))
    for size, (x, r1, scale) in k6_inputs.items():
        shape = f"({x.shape[0]}, {N})"
        timings[("K6", shape)] = paired_ms(lambda: fused_requant_shiftmax(x, r1, scale, N),
                                           lambda: fused_requant_shiftmax_reference(x, r1, scale, N), 10)
        bounds[("K6", shape)] = bound_ms(x.numel() * 6, elementwise=per_element(x.numel(), K6_TABLE_OPS))
        chain_bounds[("K6", shape)] = bound_ms(x.numel() * 6, elementwise=per_element(x.numel(), SHIFTMAX_OPS, SPLIT_OPS))
    library = {}
    for size in x16:
        args4, args5 = k4_inputs[size], k5_inputs[size]
        M = args4[0].shape[0]
        shape4, shape5 = f"({M}, {D}) x ({D}, {hidden})", f"({M}, {hidden})"
        timings[("K4", shape4)] = paired_ms(lambda: fused_linear_shiftgelu(*args4),
                                            lambda: fused_linear_shiftgelu_reference(*args4), 10)
        bounds[("K4", shape4)] = bound_ms(M * D + D * hidden + 8 * hidden + M * hidden + 256 * 256,
                                          int8_ops=2 * M * D * hidden, elementwise=per_element(M * hidden, GELU_TABLE_OPS))
        chain_bounds[("K4", shape4)] = bound_ms(M * D + D * hidden + 8 * hidden + M * hidden,
                                                int8_ops=2 * M * D * hidden, elementwise=per_element(M * hidden, GELU_OPS))
        w = fc1["w"]
        y = args4[0] if M > 16 else torch.cat([args4[0], args4[0].new_zeros((17 - M, D))])
        library[("K4", shape4)] = cuda_ms(lambda: torch._int_mm(y, w), 20)
        timings[("K5", shape5)] = paired_ms(lambda: fused_requant_shiftgelu(*args5),
                                            lambda: fused_requant_shiftgelu_reference(*args5), 10)
        bounds[("K5", shape5)] = bound_ms(M * hidden * 5 + 4 * hidden + 256 * 256,
                                          elementwise=per_element(M * hidden, K5_TABLE_OPS))
        chain_bounds[("K5", shape5)] = bound_ms(M * hidden * 5 + 4 * hidden,
                                                elementwise=per_element(M * hidden, GELU_OPS))
    for key, (k_ms, p_ms, q_ms) in timings.items():
        b, by = bounds[key]
        lib = f", torch._int_mm GEMM alone {library[key]} ms" if key in library else ""
        old = f", bound by the chain's counts {chain_bounds[key][0]} ms ({chain_bounds[key][1]})" if key in chain_bounds else ""
        print(f"{key[0]} {key[1]}: kernel {k_ms} ms (queued {q_ms} ms), plain {p_ms} ms, plain/kernel {p_ms / k_ms}, "
              f"bound {b} ms ({by}), bound/kernel {b / k_ms}{old}{lib}")
    print(f"operation counts per element (float32, int32): K7 WINDOW_TABLE_OPS {WINDOW_TABLE_OPS} + MASK_OPS "
          f"{MASK_OPS} where masked, before: SHIFTMAX_OPS {SHIFTMAX_OPS} + WINDOW_MERGE_OPS {WINDOW_MERGE_OPS}; "
          f"K4 GELU_TABLE_OPS {GELU_TABLE_OPS}, K5 K5_TABLE_OPS {K5_TABLE_OPS}, before: GELU_OPS {GELU_OPS}; "
          f"K6 K6_TABLE_OPS {K6_TABLE_OPS}, before: SHIFTMAX_OPS {SHIFTMAX_OPS} + SPLIT_OPS {SPLIT_OPS}")

    # K3 over one batch-128 forward of each model: each launch's shape
    # timed above, times its launches a forward, beside the summed bounds
    k3_forward = {
        "DeiT-S": [(f"({BATCH * N}, {D})", 2 * depth), (f"({BATCH}, {D}) final norm", 1)],
        "Swin-T": [(f"{tuple(x.shape)} Swin-T {label}",
                    1 if label.startswith("merge") else 2 * scfg["depths"][int(label[-1]) - 1]
                    + (label == f"stage {len(scfg['depths'])}"))  # the final norm has stage 4's rows
                   for (size, label), (x, _) in swin_norm_inputs.items() if size == "b128"],
    }
    for model, launches_by_shape in k3_forward.items():
        n_launches = sum(c for _, c in launches_by_shape)
        k_sum = sum(c * timings[("K3", sh)][0] for sh, c in launches_by_shape)
        q_sum = sum(c * timings[("K3", sh)][2] for sh, c in launches_by_shape)
        b_sum = sum(c * bounds[("K3", sh)][0] for sh, c in launches_by_shape)
        print(f"K3 over one batch-{BATCH} {model} forward: {n_launches} launches, kernel {k_sum} ms "
              f"(queued {q_sum} ms), summed bound {b_sum} ms, bound/kernel {b_sum / k_sum} (queued {b_sum / q_sum})")

    def device_profile(name: str, batch: int, fn, rows: int) -> list:
        """Device time by kernel over one profiled forward, and the idle
        share: 1 − kernel time / wall time (host clock to synchronize);
        returns (ms, calls, name) by kernel name."""
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            fn(images_dev[:batch])
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t1) * 1e3
        kernels = sorted(((e.self_device_time_total / 1e3, e.count, e.key) for e in prof.key_averages()
                          if e.device_type == DeviceType.CUDA), reverse=True)
        busy = sum(k[0] for k in kernels)
        print(f"profile of one batch-{batch} forward, {name}: kernel time {busy} ms in {wall} ms wall, "
              f"idle share {1 - busy / wall}, {sum(k[1] for k in kernels)} kernels")
        for ms, calls, key in kernels[:rows]:
            print(f"  {ms} ms ({ms / busy:.4f}) {calls} calls: {key[:150]}")
        return kernels

    def k3_in_profile(model: str, kernels: list) -> None:
        ms = sum(k[0] for k in kernels if "layernorm_requant_kernel" in k[2])
        calls = sum(k[1] for k in kernels if "layernorm_requant_kernel" in k[2])
        print(f"K3 in the profiled batch-{BATCH} {model} forward: {calls} launches, {ms} ms of device time")

    k3_in_profile("DeiT-S main path", device_profile("main path", BATCH, infer, 12))
    device_profile("route A", BATCH, routes16["A"], 20)
    device_profile("route A", 1, routes16["A"], 0)
    device_profile("route B", BATCH, routes16["B"], 12)
    k3_in_profile("Swin-T", device_profile("swin (Swin-T, K7+K3)", BATCH, swin, 16))

    # 6. the serving entry points. Graphs: each path captured at batch 128
    # and 1 (deploy.graphs.capture_infer), its launches counted from 0
    # through the warm-up and the capture, its replay bit-equal to the eager
    # logits above; at batch 1, eager against graphed ms/image and idle
    graph_paths = {
        "main": (infer, logits, {"K1": depth, "K3": layernorms}),
        "A": (routes16["A"], route_logits["A"], expects["A"]),
        "B": (routes16["B"], route_logits["B"], expects["B"]),
        "K1": (routes16["K1"], route_logits["K1"], expects["K1"]),
        "swin": (swin, swin_logits, {"K7": swin_blocks, "K3": swin_norms}),
        "plain": (plain8, plain8(images_dev), {}),
    }

    def host_ms(fn, x, runs: int = 40) -> float:
        """Median host ms of ``fn(x)`` to synchronize, after 5 warm calls."""
        lat = []
        for i in range(runs + 5):
            t1 = time.perf_counter()
            fn(x)
            torch.cuda.synchronize()
            if i >= 5:
                lat.append((time.perf_counter() - t1) * 1e3)
        return sorted(lat)[len(lat) // 2]

    for name, (fn, eager128, per_forward) in graph_paths.items():
        for batch in (BATCH, 1):
            for w in WRAPPERS.values():
                w.launches = 0
            t0 = time.perf_counter()
            graphed = capture_infer(fn, batch, cfg["img_size"], dev)
            capture_s = time.perf_counter() - t0
            counts = {k: w.launches for k, w in WRAPPERS.items()}
            out = graphed(images_dev[:batch])
            torch.cuda.synchronize()
            replay_counts = {k: w.launches for k, w in WRAPPERS.items()}
            print(f"graph {name} batch {batch}: captured in {capture_s:.3f} s; launches through {WARMUP} warm-up "
                  f"forwards and the capture {counts}, in the capture {graphed.launches}")
            check(graphed.launches == per_forward, f"graph {name} batch {batch}: {graphed.launches} launches a forward")
            check(all(counts[k] == (WARMUP + 1) * per_forward.get(k, 0) for k in WRAPPERS),
                  f"graph {name} batch {batch}: launches {counts}")
            check(replay_counts == counts, f"graph {name} batch {batch}: a replay counted launches")
            e_graph = float((out - eager128[:batch]).abs().max())
            print(f"graph {name} batch {batch}: replay logits vs eager: max_abs_err {e_graph} (tolerance 0)")
            check(torch.equal(out, eager128[:batch]), f"graph {name} batch {batch}: replay differs from eager")
            if batch == BATCH:
                ms = cuda_ms(lambda: graphed(images_dev), 10)
                print(f"graph {name} batch {BATCH}: {ms} ms/forward, {BATCH / ms * 1e3} images/s (CUDA events)")
            else:
                x1 = images_dev[:1]
                eager_ms, graph_ms = host_ms(fn, x1), host_ms(graphed, x1)
                device_ms = cuda_ms(lambda: graphed(x1), 50, queued=True)
                print(f"graph {name} batch 1: eager {eager_ms} ms/image, graphed {graph_ms} ms/image (host clock, "
                      f"median of 40), eager/graphed {eager_ms / graph_ms}; graphed device {device_ms} ms/forward "
                      f"back to back, idle share by events {1 - device_ms / graph_ms}")
                device_profile(f"{name} eager", 1, fn, 0)
                device_profile(f"{name} graphed", 1, graphed, 0)
            del graphed, out
        torch.cuda.empty_cache()

    # host synchronisations inside one eager batch-128 forward of each path
    # (after a warm one): none, as a capture needs. The profiled window
    # ends in a synchronize, and the profiler synchronizes too: an empty
    # window gives the count a forward must not add to
    def host_syncs(fn) -> dict:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return {c: sum(1 for e in prof.events() if e.device_type == DeviceType.CPU and e.name == c)
                for c in SYNC_CALLS}

    empty = host_syncs(lambda: None)
    for name, (fn, _, _) in graph_paths.items():
        fn(images_dev)
        syncs = host_syncs(lambda: fn(images_dev))
        print(f"host synchronisations in one eager batch-{BATCH} forward, {name}: {syncs} (an empty window: {empty})")
        check(syncs == empty, f"{name}: the forward synchronises with the host {syncs}")

    # the FP32 leg of the benchmark, TF32 off, on the card against the CPU
    # at batch 2, on the real-scale parameters; then once with TF32 on
    fp32_art = real_scale_artifact(art8)
    fp32_card = port_bench._float_vit_infer(fp32_art, dev)
    port_bench.assert_fp32_highest()
    fp32_out = fp32_card(images_dev[:2]).cpu()
    fp32_cpu = port_bench._float_vit_infer(fp32_art, "cpu")(images[:2])
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    tf32_out = fp32_card(images_dev[:2]).cpu()
    port_bench.fp32_highest()
    tol = FP32_RTOL * float(fp32_cpu.abs().max())
    e_fp32, e_tf32 = float((fp32_out - fp32_cpu).abs().max()), float((tf32_out - fp32_cpu).abs().max())
    print(f"fp32 leg, batch 2, card vs CPU: max_abs_err {e_fp32} with TF32 off, {e_tf32} with TF32 on "
          f"(tolerance {tol}: {FP32_RTOL} x max |logit| {float(fp32_cpu.abs().max())})")
    check(e_fp32 <= tol, "fp32 leg: the card differs from the CPU beyond the float32 tolerance")
    check(e_tf32 > tol, "fp32 leg: TF32 on does not miss the tolerance, so the check cannot tell TF32 off")

    # strict_dyadic, DeiT-S at full width, batch 2: the card against the CPU
    strict_card = build_vit_infer(art8, dev, kernels=(), strict_dyadic=True)(images_dev[:2]).cpu()
    strict_cpu = build_vit_infer(art8, "cpu", kernels=(), strict_dyadic=True)(images[:2])
    print(f"strict_dyadic DeiT-S batch 2: logits card vs CPU max_abs_err {float((strict_card - strict_cpu).abs().max())} "
          f"(tolerance 0); {int((strict_card != logits[:2].cpu()).sum())} of {strict_card.numel()} logits differ from "
          "the float32-requant engine's")
    check(torch.equal(strict_card, strict_cpu), "strict_dyadic: the card differs from the CPU")

    # a reference-style DeiT-S checkpoint through convert_model, then the
    # default kernels on the card against the plain engine on the CPU
    with tempfile.TemporaryDirectory() as tmp:
        ckpt, out_path = os.path.join(tmp, "checkpoint.pth.tar"), os.path.join(tmp, "artifact.pkl")
        torch.save({"model": {k: torch.from_numpy(np.array(v)) for k, v in reference_vit_state(art8).items()}}, ckpt)
        convert_model.main(["--model", "deit_small", "--torch-checkpoint", ckpt, "--softmax-bits", "8",
                            "--gelu-stable", "--output", out_path])
        ingested = load_artifact(out_path)
    ing_infer = build_vit_infer(ingested, dev)
    for w in WRAPPERS.values():
        w.launches = 0
    ing_logits = ing_infer(images_dev[:2])
    torch.cuda.synchronize()
    ing_counts = {k: w.launches for k, w in WRAPPERS.items() if w.launches}
    ing_cpu = build_vit_infer(ingested, "cpu", kernels=())(images[:2])
    print(f"ingest: kernels {sorted(ing_infer.kernels)}, launches {ing_counts}; logits vs the plain engine on the "
          f"CPU max_abs_err {float((ing_logits.cpu() - ing_cpu).abs().max())} (tolerance 0)")
    check(ing_counts == {"K1": depth, "K3": layernorms}, f"ingest: launches {ing_counts}")
    check(torch.equal(ing_logits.cpu(), ing_cpu), "ingest: the card differs from the CPU plain engine")

    # the CLIs as a user runs them
    torch.cuda.empty_cache()
    bench_lines = run_cli(["ivit_tpu_torch.bench"], 600)
    result = json.loads(bench_lines[-1])
    check(set(result) == {"metric", "value", "unit", "vs_baseline"}, f"bench: keys {sorted(result)}")
    check(all(math.isfinite(result[k]) and result[k] > 0 for k in ("value", "vs_baseline")), f"bench: {result}")
    for args, per_forward in ((["--softmax-bits", "8", "--gelu-stable"], {"K1": depth, "K3": layernorms}),
                              (["--model", "swin_tiny"], {"K7": swin_blocks, "K3": swin_norms})):
        lines = run_cli(["ivit_tpu_torch.evaluate_latency", *args], 300)
        check(re.match(r"^\S+ int8 batch=1: [0-9.]+ ms/iter, [0-9.]+ img/s$", lines[-1]) is not None,
              f"evaluate_latency {args}: last line {lines[-1]!r}")
        captured = re.search(r"launches a forward (\{.*\})", "\n".join(lines))
        check(captured is not None and ast.literal_eval(captured.group(1)) == per_forward,
              f"evaluate_latency {args}: launches a forward {captured and captured.group(1)}")

    big = {"K1": f"({BATCH * H}, {N}, {hd})", "K2": f"({BATCH * H}, {N}, {hd})",
           "K3": f"({BATCH * N}, {D})", "K4": f"({BATCH * N}, {D}) x ({D}, {hidden})",
           "K5": f"({BATCH * N}, {hidden})", "K6": f"({BATCH * H * N}, {N})",
           "K7": window_shape(window_inputs[("b128", 0, 1)][1][0], window_inputs[("b128", 0, 1)][0]["attn"])}
    sources = {"K1": ("attention_fused.cu", "attention_fused.py:126"),
               "K2": ("attention_fused_v2.cu", "attention_fused_v2.py:140"),
               "K3": ("intnorm_fused.cu", "intnorm_fused.py:74"),
               "K4": ("linear_gelu_fused.cu", "linear_gelu_fused.py:87"),
               "K5": ("shiftgelu_fused.cu", "shiftgelu_fused.py:79"),
               "K6": ("shiftmax_fused.cu", "shiftmax_fused.py:95"),
               "K7": ("window_attention_fused.cu", "window_attention_fused.py:132")}
    launches = {"K1": main_counts["K1"], "K3": main_counts["K3"], "K2": route_counts["A"]["K2"],
                "K4": route_counts["A"]["K4"], "K5": route_counts["B"]["K5"], "K6": route_counts["B"]["K6"],
                "K7": swin_counts["K7"]}
    record = {"kernels": []}
    for name, fn in WRAPPERS.items():
        key = (name, big[name])
        src, tpu = sources[name]
        record["kernels"].append({
            "name": f"{name} {fn.__name__}", "route": "cuda",
            "source": f"ivit_tpu_torch/csrc/{src}", "replaces": f"ivit_tpu/kernels/{tpu}",
            "launches": launches[name], "max_abs_err": errs[name],
            "ms": timings[key][0], "queued_ms": timings[key][2], "plain_ms": timings[key][1],
            "bound_ms": bounds[key][0], "bound_by": bounds[key][1],
            "library_ms": library.get(key),
        })
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
