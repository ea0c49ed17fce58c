#!/usr/bin/env python3
"""Repeat the card-against-CPU QAT forward check in one process.

Runs ``tests/test_torch_cuda.py::test_qat_train_forward_on_card_matches_cpu``
(two train-mode forwards of a tiny DeiT on the card and on the CPU; logits,
ranges and loss bit-equal, gradients within its bound) N times for each
of its parameters, and prints how many failed and each failure's message,
which names the forward and the first module whose output, scale or range
differs. Needs a CUDA device; from the repository root:

    python scripts/torch_repeat_qat_forward.py 60
"""

import collections
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_repeat_qat_forward: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
    import test_torch_cuda

    n = int(sys.argv[1]) if len(sys.argv) > 1 else 50
    dev = torch.device("cuda")
    fails, messages = collections.Counter(), []
    t0 = time.perf_counter()
    for rep in range(n):
        for bits, stable in ((16, False), (8, False), (8, True)):
            try:
                test_torch_cuda.test_qat_train_forward_on_card_matches_cpu(dev, bits, stable)
            except AssertionError as e:
                fails[(bits, stable)] += 1
                messages.append(f"rep {rep} [{bits}-{stable}]: {str(e)[:600]}")
    print(f"{n} repetitions x 3 parameters in {time.perf_counter() - t0:.1f} s; failures {dict(fails)}")
    for m in messages[:40]:
        print(m)
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
