"""Exact int8 × int8 → int32 GEMM through ``torch._int_mm``, at any shape.

``torch._int_mm`` on CUDA refuses 16 rows or fewer, fewer than 800 rows
when K < 128 (CUBLAS_STATUS_NOT_SUPPORTED; measured on the H100 with
torch 2.11.0+cu128 over K 16-128, M 17-3136), and K or N that are not
multiples of 8. ``int8_matmul`` pads with zero rows and columns, which
change no integer, and cuts the product back. The deploy engine's
GEMMs and the QAT layers' exact forward dots both go through it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def int_mm_min_rows(k: int) -> int:
    """The fewest rows ``torch._int_mm`` takes on CUDA at inner width k."""
    return 17 if k >= 128 else 800


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
    rows = max(M, int_mm_min_rows(k8)) if x.is_cuda else M
    if rows > M or k8 > K:
        x = F.pad(x, (0, k8 - K, 0, rows - M))
    acc = torch._int_mm(x.contiguous(), w)
    n = nw if n is None else n
    if rows > M or n < acc.shape[1]:
        acc = acc[:M, :n].contiguous()
    return acc
