#!/usr/bin/env python3
"""Does a DeiT-S QAT train step fit on the card at a given batch?

Runs two train steps of the port's trainer (``ivit_tpu_torch.train``,
``chip_smoke.py`` phase 7's configuration: DeiT-S, drop-path 0.1, AdamW,
the EMA) at each batch given (default 64 and 128) on seeded normal
images, and prints one JSON line per batch: whether it fit, the peak
``torch.cuda.max_memory_allocated`` in bytes, the card's total memory,
and the second step's ms (CUDA events), or the out-of-memory message.

Usage, from the repository root on a machine with one card:
``python scripts/torch_train_memory.py [batch ...]``
"""

from __future__ import annotations

import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv: list[str]) -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_train_memory: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from ivit_tpu_torch.models import create_model
    from ivit_tpu_torch.train import AdamW, create_train_state, make_train_step

    dev = torch.device("cuda", 0)
    total = torch.cuda.get_device_properties(dev).total_memory
    for b in [int(a) for a in argv] or [64, 128]:
        rng = np.random.default_rng(b)
        x = torch.from_numpy(rng.standard_normal((b, 224, 224, 3), dtype=np.float32)).to(dev)
        t = torch.full((b, 1000), 0.1 / 1000, device=dev)
        t[torch.arange(b), torch.from_numpy(rng.integers(0, 1000, b)).to(dev)] += 0.9
        model = create_model("deit_small", dev, drop_path_rate=0.1)
        state = create_train_state(model, AdamW(1e-6), ema_decay=0.99996, device=dev)
        step = make_train_step(model, ema_decay=0.99996)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        row = {"batch": b, "total_bytes": total}
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
        del model, state, step, x, t
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
