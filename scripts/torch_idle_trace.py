#!/usr/bin/env python3
"""Where a forward's device idles, from one profiled forward of one
checkout: the gaps between kernels on the device timeline, grouped by the
kernel that ends the gap, and the host's synchronising calls.

Usage: ``python scripts/torch_idle_trace.py ROOT [ROUTE]`` builds route
``ROUTE`` (``main``, ``route_a``, ``route_b`` or ``swin_t``; default
``route_b``) of the ``ivit_tpu_torch`` package found in the checkout at
ROOT on the seeded synthetic artifacts of ``chip_smoke.py``, runs three
batch-128 forwards to warm up, then profiles one (``torch.profiler``,
CPU and CUDA). It prints one JSON line: the forward's wall ms (host clock
to ``synchronize``), its kernel ms, its idle ms (the sum of the gaps
between consecutive kernels), the idle ms before the kernels that follow
a K6 launch, the largest idle by following kernel name, and the count
of each host call that waits on the device (``cudaStreamSynchronize``,
``cudaDeviceSynchronize``, ``cudaMemcpy``). Exits nonzero without a CUDA
device.
"""

from __future__ import annotations

import json
import os
import sys
import time

BATCH = 128
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaMemcpy")


def main() -> int:
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    route = sys.argv[2] if len(sys.argv) > 2 else "route_b"
    if len(sys.argv) not in (2, 3) or not os.path.isdir(os.path.join(sys.argv[1], "ivit_tpu_torch")):
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("torch_idle_trace: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.abspath(sys.argv[1])
    sys.path.insert(0, root)
    from ivit_tpu_torch.deploy.engine import build_vit_infer
    from ivit_tpu_torch.deploy.swin_engine import build_swin_infer
    from ivit_tpu_torch.deploy.swin_synthetic import synthetic_swin_artifact
    from ivit_tpu_torch.deploy.synthetic import synthetic_vit_artifact

    dev = torch.device("cuda", 0)
    images = torch.from_numpy(np.random.default_rng(1).standard_normal((BATCH, 224, 224, 3), dtype=np.float32)).to(dev)
    if route == "swin_t":
        fn = build_swin_infer(synthetic_swin_artifact("swin_tiny", seed=0), dev)
    elif route == "main":
        fn = build_vit_infer(synthetic_vit_artifact("deit_small", seed=0, softmax_bits=8, gelu_stable=True), dev)
    else:
        kernels = {"route_a": ("layernorm", "attention2", "linear_gelu"), "route_b": ("layernorm", "softmax", "gelu")}
        fn = build_vit_infer(synthetic_vit_artifact("deit_small", seed=0, softmax_bits=16, gelu_stable=False), dev,
                             kernels=kernels[route])
    for _ in range(3):
        fn(images)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        fn(images)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t1) * 1e3
    events = prof.events()
    kernels = sorted(((e.time_range.start, e.time_range.end, e.name) for e in events
                      if e.device_type == DeviceType.CUDA), key=lambda k: k[0])
    idle_by_next, after_k6, idle = {}, 0.0, 0.0
    for (_, prev_end, prev_name), (start, _, name) in zip(kernels, kernels[1:]):
        gap = max(0.0, start - prev_end) / 1e3
        idle += gap
        idle_by_next[name[:80]] = idle_by_next.get(name[:80], 0.0) + gap
        if "requant_shiftmax" in prev_name:
            after_k6 += gap
    syncs = {c: sum(1 for e in events if e.device_type == DeviceType.CPU and e.name.startswith(c)) for c in SYNC_CALLS}
    top = sorted(idle_by_next.items(), key=lambda t: -t[1])[:6]
    print(json.dumps({
        "root": root, "route": route, "device": torch.cuda.get_device_name(0), "wall_ms": wall,
        "kernel_ms": sum(e - s for s, e, _ in kernels) / 1e3, "kernels": len(kernels), "idle_ms": idle,
        "idle_after_k6_ms": after_k6, "host_syncs": syncs, "idle_by_next_kernel_ms": dict(top),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
