#!/usr/bin/env python3
"""Speed of the port's QAT trainer, one turn of one checkout, for paired
turns of two checkouts on one GPU.

Usage: ``python scripts/torch_train_turns.py ROOT`` times the
``ivit_tpu_torch`` package found in the checkout at ROOT on
``chip_smoke.py`` phase 7's configuration (DeiT-S at full width and
depth, sm16 + row-max GELU, drop-path 0.1, AdamW with weight decay 1e-4,
the EMA) on seeded normal images: the train step at batch 64 as ms per
step by CUDA events over 5 steps after one warm-up step, and the SIM
eval forward (``model(x)`` under ``torch.no_grad``) at batch 128 as ms
per forward over 5 forwards after 2. Run it for two checkouts in
alternating order (parent, change, change, parent, ...) and compare the
medians. Prints one JSON line; exits nonzero without a CUDA device.
"""

from __future__ import annotations

import json
import os
import sys

TRAIN_BATCH, TRAIN_STEPS = 64, 5
EVAL_BATCH, EVAL_ITERS = 128, 5


def events_ms(fn, iters: int, warmup: int) -> float:
    """Mean ms of ``fn()`` by CUDA events, after ``warmup`` calls."""
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


def main(argv: list[str]) -> int:
    import numpy as np
    import torch

    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("torch_train_turns: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.abspath(argv[0])
    sys.path.insert(0, root)
    from ivit_tpu_torch.models import create_model
    from ivit_tpu_torch.train import AdamW, create_train_state, make_train_step

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((TRAIN_BATCH, 224, 224, 3), dtype=np.float32)).to(dev)
    t = torch.full((TRAIN_BATCH, 1000), 0.1 / 1000, device=dev)
    t[torch.arange(TRAIN_BATCH), torch.from_numpy(rng.integers(0, 1000, TRAIN_BATCH)).to(dev)] += 0.9
    model = create_model("deit_small", dev, seed=0, drop_path_rate=0.1)
    state = create_train_state(model, AdamW(1e-6, weight_decay=1e-4), ema_decay=0.99996, device=dev)
    step = make_train_step(model, ema_decay=0.99996)
    gen = torch.Generator(device=dev).manual_seed(0)
    step_ms = events_ms(lambda: step(state, x, t, gen), TRAIN_STEPS, 1)

    xe = torch.from_numpy(rng.standard_normal((EVAL_BATCH, 224, 224, 3), dtype=np.float32)).to(dev)
    with torch.no_grad():
        eval_ms = events_ms(lambda: model(xe), EVAL_ITERS, 2)
    print(json.dumps({"root": root, "card": torch.cuda.get_device_name(0),
                      "train_step_ms": step_ms, "train_images_per_s": TRAIN_BATCH * 1000 / step_ms,
                      "eval_forward_ms": eval_ms, "eval_images_per_s": EVAL_BATCH * 1000 / eval_ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
