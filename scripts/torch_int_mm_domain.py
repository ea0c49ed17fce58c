#!/usr/bin/env python3
"""Which shapes ``torch._int_mm`` takes on the card.

Calls ``torch._int_mm`` on (M, K) x (K, N) int8 operands over two sets
of shapes: a grid (K and N multiples of 8 from 8 to 256, M in ROWS) and
every M from 1 to 2,048 at the (K, N) pairs of DENSE. It records every
shape cuBLAS refuses (``RuntimeError``) and every product that differs
from the exact one, and checks ``ops.intmm.int8_matmul``, which pads
operands around those refusals, at every shape. Prints the card, then
one JSON object: the refused shapes by (K, N) and the shapes where
``int8_matmul`` failed or was not exact. Exits nonzero without a CUDA
device.

Usage: ``python scripts/torch_int_mm_domain.py`` from the repository root.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import torch

ROWS = (17, 24, 64, 128, 256, 512, 799, 800, 1024, 1960, 3136, 8192, 25216)
WIDTHS = tuple(range(8, 264, 8))
DENSE = [(k, n) for k in (8, 16, 64, 120, 128, 136, 256) for n in (8, 16, 24, 32, 40, 64, 256)]


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_int_mm_domain: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from ivit_tpu_torch.ops.intmm import int8_matmul

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    refused, wrong, helper_bad = {}, [], []
    shapes = [(K, N, ROWS) for K in WIDTHS for N in WIDTHS] + [(K, N, range(1, 2049)) for K, N in DENSE]
    for K, N, rows in shapes:
        w = torch.randint(-128, 128, (K, N), generator=gen, dtype=torch.int8, device=dev)
        for M in rows:
            x = torch.randint(-128, 128, (M, K), generator=gen, dtype=torch.int8, device=dev)
            # float64 products and sums of int8 values are exact (below 2^53)
            exact = (x.to(torch.float64) @ w.to(torch.float64)).to(torch.int32)
            try:
                out = torch._int_mm(x, w)
                torch.cuda.synchronize()
                if not torch.equal(out, exact):
                    wrong.append((M, K, N))
            except RuntimeError:
                refused.setdefault(f"{K}x{N}", set()).add(M)
            try:
                ok = torch.equal(int8_matmul(x, w), exact)
            except RuntimeError as err:
                ok = False
                print(f"int8_matmul ({M}, {K}) x ({K}, {N}): {str(err).splitlines()[0]}", file=sys.stderr)
            if not ok:
                helper_bad.append((M, K, N))
    print(json.dumps({"rows": ROWS, "widths": [WIDTHS[0], WIDTHS[-1], 8], "dense": DENSE,
                      "refused": {kn: sorted(ms) for kn, ms in refused.items()},
                      "wrong": wrong, "int8_matmul_failed": helper_bad}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
