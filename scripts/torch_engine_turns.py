#!/usr/bin/env python3
"""Throughput and latency of the port's four engine paths, one turn of one
checkout, for paired turns of two checkouts on one GPU.

Usage: ``python scripts/torch_engine_turns.py ROOT`` times the
``ivit_tpu_torch`` package found in the checkout at ROOT (its kernels
are built there at first use) on the seeded synthetic artifacts of
``chip_smoke.py``: the DeiT-S main path (softmax_bits=8, stable GELU;
K1 + K3), route A (softmax_bits=16, row-max GELU; K2 + K4 + K3), route
B (the same model; K6 + K5 + K3) and Swin-T (K7 + K3), each as ms per
batch-128 forward by CUDA events over 10 forwards after 3 of warm-up,
and as the median ms of a batch-1 forward on the host clock (forward and
synchronize, 50 runs after 10), as ``chip_smoke.py`` times them; and K3
at every width of those paths and K5 and K6 at route B's shapes, on seeded
inputs, as ms per launch by CUDA events over 20 launches, launched as a
caller launches them (``ms``) and queued behind a spin kernel (``queued
ms``), with ``chip_smoke.py``'s ``cuda_ms`` (this script's own
checkout's); and the host µs a call of each kernel's wrapper, K1-K7,
takes to return at its path's batch-128 shape (``K1 host us`` ...,
``chip_smoke.py``'s ``host_us`` on its ``wrapper_calls``: 200 calls
queued behind a spin kernel, so that none waits on the device).
Run it for two checkouts in alternating order (parent, change, change,
parent, ...) and compare the medians. Prints one JSON line; exits
nonzero without a CUDA device.
"""

from __future__ import annotations

import json
import os
import sys
import time

BATCH = 128
ITERS = 10
KERNEL_ITERS = 20
LATENCY_RUNS = 50
# K3's (rows, width) on the batch-128 paths: DeiT-S and Swin-T's four
# stages and three patch mergings
K3_SHAPES = ((25216, 384), (401408, 96), (100352, 192), (25088, 384), (6272, 768),
             (100352, 384), (25088, 768), (6272, 1536))
K5_SHAPE = (25216, 1536)
K6_SHAPE = (151296, 197)  # DeiT-S batch 128: 768 heads x 197 query rows, 197 keys


def batch1_ms(fn, image) -> float:
    """Median host-clock ms of a batch-1 forward and its synchronize."""
    import torch

    lat = []
    for i in range(10 + LATENCY_RUNS):
        t1 = time.perf_counter()
        fn(image)
        torch.cuda.synchronize()
        if i >= 10:
            lat.append((time.perf_counter() - t1) * 1e3)
    return sorted(lat)[len(lat) // 2]


def main() -> int:
    import numpy as np
    import torch

    if len(sys.argv) != 2 or not os.path.isdir(os.path.join(sys.argv[1], "ivit_tpu_torch")):
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("torch_engine_turns: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.abspath(sys.argv[1])
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from chip_smoke import cuda_ms, host_us, wrapper_calls

    sys.path[0] = root  # the package under test comes from ROOT
    from ivit_tpu_torch import kernels
    from ivit_tpu_torch.deploy.engine import build_vit_infer
    from ivit_tpu_torch.deploy.swin_engine import build_swin_infer
    from ivit_tpu_torch.deploy.swin_synthetic import synthetic_swin_artifact
    from ivit_tpu_torch.deploy.synthetic import synthetic_vit_artifact
    from ivit_tpu_torch.kernels import fused_layernorm_requant, fused_requant_shiftgelu, fused_requant_shiftmax

    dev = torch.device("cuda", 0)
    images = torch.from_numpy(np.random.default_rng(1).standard_normal((BATCH, 224, 224, 3), dtype=np.float32)).to(dev)
    art16 = synthetic_vit_artifact("deit_small", seed=0, softmax_bits=16, gelu_stable=False)
    engines = {
        "main": build_vit_infer(synthetic_vit_artifact("deit_small", seed=0, softmax_bits=8, gelu_stable=True), dev),
        "route_a": build_vit_infer(art16, dev, kernels=("layernorm", "attention2", "linear_gelu")),
        "route_b": build_vit_infer(art16, dev, kernels=("layernorm", "softmax", "gelu")),
        "swin_t": build_swin_infer(synthetic_swin_artifact("swin_tiny", seed=0), dev),
    }
    result = {"root": root, "device": torch.cuda.get_device_name(0)}
    for name, fn in engines.items():
        ms = cuda_ms(lambda: fn(images), ITERS)
        result[f"{name}_ms"] = ms
        result[f"{name}_images_per_s"] = BATCH / ms * 1e3
        result[f"{name}_batch1_ms"] = batch1_ms(fn, images[:1])
    rng = np.random.default_rng(2)
    for M, C in K3_SHAPES:
        x = torch.from_numpy(rng.integers(-3000, 3000, (M, C)).astype(np.int16)).to(dev)
        bias = torch.from_numpy(np.floor(rng.standard_normal(C) * 2**20).astype(np.float32)).to(dev)
        ratio = torch.from_numpy((rng.uniform(0.5, 2.0, C) * np.sqrt(C) * 2.0**-25).astype(np.float32)).to(dev)
        for label, queued in (("ms", False), ("queued ms", True)):
            result[f"K3 ({M}, {C}) {label}"] = cuda_ms(lambda: fused_layernorm_requant(x, bias, ratio),
                                                       KERNEL_ITERS, queued=queued)
    M, C = K5_SHAPE
    acc = torch.from_numpy(rng.integers(-(2**20), 2**20, (M, C)).astype(np.int32)).to(dev)
    r1 = torch.from_numpy((rng.uniform(0.5, 2.0, C) * 1e-4).astype(np.float32)).to(dev)
    s_in, r2 = float(np.float32(0.031)), float(np.float32(0.7))
    for label, queued in (("ms", False), ("queued ms", True)):
        result[f"K5 ({M}, {C}) {label}"] = cuda_ms(lambda: fused_requant_shiftgelu(acc, r1, s_in, r2),
                                                   KERNEL_ITERS, queued=queued)
    M, N = K6_SHAPE
    scores = torch.from_numpy(rng.integers(-(2**20), 2**20, (M, N)).astype(np.int32)).to(dev)
    r1, scale = float(np.float32(3.1e-5)), float(np.float32(0.021))
    for label, queued in (("ms", False), ("queued ms", True)):
        result[f"K6 ({M}, {N}) {label}"] = cuda_ms(lambda: fused_requant_shiftmax(scores, r1, scale, N),
                                                   KERNEL_ITERS, queued=queued)
    for name, fn in wrapper_calls(kernels, dev).items():
        result[f"{name} host us"] = host_us(fn)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
