"""Exact int8 × int8 → int32 GEMM through ``torch._int_mm``, at any shape.

``torch._int_mm`` on CUDA refuses 16 rows or fewer; below K = 128, at N
of 32 or more, every row count that is not a multiple of 32
(CUBLAS_STATUS_NOT_SUPPORTED); and K or N that are not multiples of 8
(measured on the H100 with torch 2.11.0+cu128 by
``scripts/torch_int_mm_domain.py``: K and N from 8 to 256, every M to
2,048). ``int8_matmul`` pads with zero rows and columns, which change no
integer, and cuts the product back. The deploy engine's GEMMs and the
QAT layers' exact forward dots both go through it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def int_mm_rows(m: int, k: int) -> int:
    """The rows to give ``torch._int_mm`` on CUDA for ``m`` rows at inner
    width k: at least 17, and below k = 128 a multiple of 32."""
    return max(m, 17) if k >= 128 else max(32, -(-m // 32) * 32)


def int8_matmul(x: torch.Tensor, w: torch.Tensor, n: int | None = None) -> torch.Tensor:
    """(M, K) int8 @ (K', N') int8 → (M, n) int32, exact, for K ≤ K'
    (x's missing columns are zeros: ``deploy.artifact.carry_linear``
    carries weights zero-padded to multiples of 8 with their true N as
    ``n``); ``n`` defaults to N'."""
    M, K = x.shape
    kw, nw = w.shape
    k8, n8 = -(-kw // 8) * 8, -(-nw // 8) * 8
    if (k8, n8) != (kw, nw):
        w = F.pad(w, (0, n8 - nw, 0, k8 - kw))
    rows = int_mm_rows(M, k8) if x.is_cuda else M
    if rows > M or k8 > K:
        x = F.pad(x, (0, k8 - K, 0, rows - M))
    acc = torch._int_mm(x.contiguous(), w)
    n = nw if n is None else n
    if rows > M or n < acc.shape[1]:
        acc = acc[:M, :n].contiguous()
    return acc
