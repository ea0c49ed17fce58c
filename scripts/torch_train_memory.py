#!/usr/bin/env python3
"""Does a QAT train step fit on the card at a given batch?

Runs two train steps of the port's trainer (``ivit_tpu_torch.train``:
drop-path 0.1, AdamW at lr 1e-6, the EMA at decay 0.99996, smoothed
one-hot targets; DeiT-S unless ``--model`` names another registered
model) at 224² with 1000 classes at each batch given (default 64 and
128) on seeded normal images, and prints one JSON line per batch: the model, whether
it fit, the peak ``torch.cuda.max_memory_allocated`` in bytes, the
card's name and total memory, and the second step's ms (CUDA events),
or the out-of-memory message. One model and train state serve the
batches, in the order given. ``--remat`` builds the model with
``remat=True`` (each block recomputed in the backward) and says so in
every line.

Usage, from the repository root on a machine with one card:
``python scripts/torch_train_memory.py [--model NAME] [--remat] [batch ...]``
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv: list[str]) -> int:
    import numpy as np
    import torch

    p = argparse.ArgumentParser("torch_train_memory")
    p.add_argument("--model", default="deit_small")
    p.add_argument("--remat", action="store_true", help="recompute each block in the backward")
    p.add_argument("batches", nargs="*", type=int, default=[64, 128])
    args = p.parse_args(argv)

    if not torch.cuda.is_available():
        print("torch_train_memory: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from ivit_tpu_torch.models import create_model
    from ivit_tpu_torch.train import AdamW, create_train_state, make_train_step

    dev = torch.device("cuda", 0)
    total = torch.cuda.get_device_properties(dev).total_memory
    model = create_model(args.model, dev, drop_path_rate=0.1, remat=args.remat)
    state = create_train_state(model, AdamW(1e-6), ema_decay=0.99996, device=dev)
    step = make_train_step(model, ema_decay=0.99996)
    for b in args.batches:
        rng = np.random.default_rng(b)
        x = torch.from_numpy(rng.standard_normal((b, 224, 224, 3), dtype=np.float32)).to(dev)
        t = torch.full((b, 1000), 0.1 / 1000, device=dev)
        t[torch.arange(b), torch.from_numpy(rng.integers(0, 1000, b)).to(dev)] += 0.9
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        row = {"model": args.model, "remat": args.remat, "batch": b, "device": torch.cuda.get_device_name(dev),
               "total_bytes": total}
        try:
            step(state, x, t)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            step(state, x, t)
            end.record()
            end.synchronize()
            row.update(fits=True, peak_bytes=torch.cuda.max_memory_allocated(dev), step_ms=start.elapsed_time(end))
        except torch.cuda.OutOfMemoryError as e:
            row.update(fits=False, peak_bytes=torch.cuda.max_memory_allocated(dev), error=str(e).splitlines()[0])
        print(json.dumps(row), flush=True)
        del x, t
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
