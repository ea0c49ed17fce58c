#!/usr/bin/env python3
"""Batch-128 throughput of the port's DeiT-S route A and Swin-T engines,
one turn of one checkout, for paired turns of two checkouts on one GPU.

Usage: ``python scripts/torch_engine_turns.py ROOT`` times the
``ivit_tpu_torch`` package found in the checkout at ROOT (its kernels
are built there at first use) on the seeded synthetic artifacts of
``chip_smoke.py``: route A (softmax_bits=16, row-max GELU; K2 + K4 + K3)
and Swin-T (K7 + K3), each as ms per batch-128 forward by CUDA events
over 10 forwards after 3 of warm-up, as ``chip_smoke.py`` times them.
Run it for two checkouts in alternating order (parent, change, change,
parent, ...) and compare the medians. Prints one JSON line; exits
nonzero without a CUDA device.
"""

from __future__ import annotations

import json
import os
import sys

BATCH = 128
ITERS = 10


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
    sys.path.insert(0, root)
    from ivit_tpu_torch.deploy.engine import build_vit_infer
    from ivit_tpu_torch.deploy.swin_engine import build_swin_infer
    from ivit_tpu_torch.deploy.swin_synthetic import synthetic_swin_artifact
    from ivit_tpu_torch.deploy.synthetic import synthetic_vit_artifact

    dev = torch.device("cuda", 0)
    images = torch.from_numpy(np.random.default_rng(1).standard_normal((BATCH, 224, 224, 3), dtype=np.float32)).to(dev)
    engines = {
        "route_a": build_vit_infer(synthetic_vit_artifact("deit_small", seed=0, softmax_bits=16, gelu_stable=False), dev,
                                   kernels=("layernorm", "attention2", "linear_gelu")),
        "swin_t": build_swin_infer(synthetic_swin_artifact("swin_tiny", seed=0), dev),
    }
    result = {"root": root, "device": torch.cuda.get_device_name(0)}
    for name, fn in engines.items():
        for _ in range(3):
            fn(images)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(ITERS):
            fn(images)
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / ITERS
        result[f"{name}_ms"] = ms
        result[f"{name}_images_per_s"] = BATCH / ms * 1e3
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
