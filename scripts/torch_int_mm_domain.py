#!/usr/bin/env python3
"""Which shapes ``torch._int_mm`` takes on the card.

Calls ``torch._int_mm`` on (M, K) x (K, N) int8 operands over three sets
of shapes: a grid (K and N multiples of 8 from 8 to 256, M in ROWS);
every M from 1 to 2,048 at the (K, N) pairs of DENSE; and every (K, N)
of a GEMM in the registry's models (``zoo_gemms``: patch embed, qkv,
proj, fc1, fc2, Swin's patch merging and the head) at every M from 1 to
2,048 and at the row counts the CLIs give that GEMM at the batches in
CLI_BATCHES (``zoo_rows``). It records every shape cuBLAS refuses
(``RuntimeError``) and every product that differs from the exact one,
and checks ``ops.intmm.int8_matmul``, which pads operands around those
refusals, at every shape. Prints the card, then one JSON object: the
refused shapes by (K, N), the shapes where ``int8_matmul`` failed or was
not exact, and the zoo's shape counts. Exits nonzero without a CUDA
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
# quant_train's batch (64), its validation batch (1.5 x 64) and the last
# one of the synthetic set (128 - 96), evaluate_accuracy's default batch,
# and the Swin CLI run's validation batch (1.5 x 32)
CLI_BATCHES = (64, 96, 32, 128, 48)


def zoo_gemms() -> dict:
    """{(K, N): {tokens a row of that GEMM comes from per image, or 1 for
    the head}} over every registered model at 224 and 1000 classes."""
    from ivit_tpu_torch.models.registry import MODEL_REGISTRY, create_config

    gemms: dict = {}

    def add(k: int, n: int, tokens: int) -> None:
        gemms.setdefault((k, n), set()).add(tokens)

    for name in MODEL_REGISTRY:
        cfg = create_config(name)
        patch, size = cfg["patch_size"], cfg["img_size"]
        if "depths" in cfg:  # Swin: the width doubles and the tokens quarter at each merge
            dim, res = cfg["embed_dim"], size // patch
            add(patch * patch * 3, dim, res * res)
            for stage in range(len(cfg["depths"])):
                tokens = res * res
                for k, n in ((dim, 3 * dim), (dim, dim), (dim, 4 * dim), (4 * dim, dim)):
                    add(k, n, tokens)
                if stage < len(cfg["depths"]) - 1:
                    res //= 2
                    add(4 * dim, 2 * dim, res * res)
                    dim *= 2
            add(dim, cfg["num_classes"], 1)
        else:
            d, tokens = cfg["embed_dim"], (size // patch) ** 2 + 1
            hidden = int(d * cfg["mlp_ratio"])
            add(patch * patch * 3, d, tokens - 1)
            for k, n in ((d, 3 * d), (d, d), (d, hidden), (hidden, d)):
                add(k, n, tokens)
            add(d, cfg["num_classes"], 1)
    return gemms


def zoo_rows(tokens: set) -> list:
    """Every M from 1 to 2,048, then the CLIs' row counts above 2,048."""
    big = {b * t for b in CLI_BATCHES for t in tokens} - set(range(1, 2049))
    return list(range(1, 2049)) + sorted(big)


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
    zoo = zoo_gemms()
    shapes = ([(K, N, ROWS) for K in WIDTHS for N in WIDTHS] + [(K, N, range(1, 2049)) for K, N in DENSE]
              + [(K, N, zoo_rows(tokens)) for (K, N), tokens in sorted(zoo.items())])
    n_shapes = 0
    for K, N, rows in shapes:
        w = torch.randint(-128, 128, (K, N), generator=gen, dtype=torch.int8, device=dev)
        # one operand of the most rows; every M takes its first M rows
        x_all = torch.randint(-128, 128, (max(rows), K), generator=gen, dtype=torch.int8, device=dev)
        # float64 products and sums of int8 values are exact (below 2^53)
        exact_all = (x_all.to(torch.float64) @ w.to(torch.float64)).to(torch.int32)
        for M in rows:
            x, exact = x_all[:M], exact_all[:M]
            n_shapes += 1
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
        del x_all, exact_all
    zoo_refused = {kn: ms for kn, ms in refused.items() if tuple(map(int, kn.split("x"))) in zoo}
    print(json.dumps({"rows": ROWS, "widths": [WIDTHS[0], WIDTHS[-1], 8], "dense": DENSE,
                      "zoo": sorted(f"{k}x{n}" for k, n in zoo), "cli_batches": CLI_BATCHES,
                      "shapes": n_shapes, "zoo_shapes": sum(len(zoo_rows(t)) for t in zoo.values()),
                      "refused": {kn: sorted(ms) for kn, ms in refused.items()},
                      "zoo_refused_rows": {kn: len(ms) for kn, ms in zoo_refused.items()},
                      "wrong": wrong, "int8_matmul_failed": helper_bad}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
