#!/usr/bin/env python3
"""Run serialized engines in a fresh process that builds none.

Loads each engine file given with ``ivit_tpu_torch.deploy.load_engine``
(``torch.export.load`` and the operator library
``ivit_tpu_torch.kernels``; no artifact is read and no engine is built),
runs it on the first images in ``IMAGES`` (a ``.npy`` of (B, H, W, 3)
float32; as many as the program's batch, moved to its device), writes
the logits beside the engine as ``<engine>.logits.npy``, and prints one
JSON line per engine: the
launches of each kernel in one forward (every count set to 0 just
before it and read just after; on the CPU, where each operator runs its
plain version, none) and the device.

Usage, from the repository root:
``python scripts/torch_reload_engine.py IMAGES ENGINE [ENGINE ...]``
"""

from __future__ import annotations

import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv: list[str]) -> int:
    import numpy as np
    import torch

    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from ivit_tpu_torch.deploy.export import load_engine
    from ivit_tpu_torch.kernels import WRAPPERS

    images = np.load(argv[0])
    for path in argv[1:]:
        engine = load_engine(path)
        x = torch.from_numpy(images[:engine.images_shape[0]]).to(engine.device)
        for wrapper in WRAPPERS.values():
            wrapper.launches = 0
        logits = engine(x)
        launches = {name: w.launches for name, w in WRAPPERS.items() if w.launches}
        np.save(path + ".logits.npy", logits.cpu().numpy())
        print(json.dumps({"engine": path, "launches": launches, "device": str(engine.device)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
