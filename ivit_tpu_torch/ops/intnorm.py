"""I-LayerNorm: integer-only LayerNorm with a Newton integer square root.

Counterpart of ``ivit_tpu/ops/intnorm.py`` (DEPLOY): exact one-pass
``(Σq, Σq²)`` in int32 lanes, the fixed f32 recombine tree, mean =
round(Σq/D), ten Newton steps ``k ← ⌊(k + ⌊var/k⌋)/2⌋`` seeded at 2^16,
``factor = ⌊(2^31−1)/std⌋``; γ folds into the per-channel output scale
``γ·√D/2^30`` and β into an integer bias.
"""

from __future__ import annotations

import math

import torch

from .interp import I32_MAX, div

_NEWTON_ITERS = 10


def _exact_stats(q: torch.Tensor, carrier_bound: int = 2**15):
    """One-pass (Σq, Σq²) over the last axis, exact in int32.

    ``q = a·2^8 + b`` with ``a = q≫8``, ``b = q&255``. Rows of at most
    ``min(1000, merge_limit)`` columns merge the a² and ab accumulators
    (``q² = (a²·2^7 + ab)·2^9 + b²``); longer rows keep three. Returns
    ``(Σq as int32, Σq² as the recombined float32)``.
    """
    d = q.shape[-1]
    big_a = max(carrier_bound >> 8, 1)
    if d * big_a * big_a >= 2**31:
        raise ValueError(f"_exact_stats: d={d} at carrier_bound={carrier_bound} overflows int32")
    merge_limit = (2**31 - 1) // (big_a * big_a * 128 + big_a * 256)
    qi = q.to(torch.int32)
    a = qi >> 8
    b = qi & 255
    s_q = qi.sum(-1, keepdim=True, dtype=torch.int32)
    s_bb = (b * b).sum(-1, keepdim=True, dtype=torch.int32)
    if d <= min(1000, merge_limit):
        s_t = (a * a * 128 + a * b).sum(-1, keepdim=True, dtype=torch.int32)
        sq2 = s_t.to(torch.float32) * 2.0**9 + s_bb.to(torch.float32)
    else:
        s_aa = (a * a).sum(-1, keepdim=True, dtype=torch.int32)
        s_ab = (a * b).sum(-1, keepdim=True, dtype=torch.int32)
        sq2 = (
            s_aa.to(torch.float32) * 2.0**16
            + s_ab.to(torch.float32) * 2.0**9
            + s_bb.to(torch.float32)
        )
    return s_q, sq2


def int_layernorm(q: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor):
    """Integer LayerNorm over the last axis of integer-valued ``q``
    (float32 carrier or an integer dtype within int16 range).

    Returns ``(q_out, scale_out)``: integer-valued float32 and the
    per-channel scale ``γ·√D/2^30``.
    """
    d = q.shape[-1]
    if d > 8192:
        raise ValueError("exact int32 LayerNorm stats need row length <= 8192")
    base_scale = math.sqrt(d) / 2.0**30

    s_q, sq2 = _exact_stats(q)
    sum_f = s_q.to(torch.float32)
    mean = torch.round(div(sum_f, float(d)))
    # var = Σq² − 2mΣq + Dm² (fixed expression tree)
    var = sq2 - 2.0 * mean * sum_f + d * mean * mean
    var = torch.clamp(var, min=0.0)  # guard f32 cancellation
    y = q.to(torch.float32) - mean

    k = torch.full_like(var, 2.0**16)
    for _ in range(_NEWTON_ITERS):
        k = torch.floor((k + torch.floor(div(var, k))) / 2.0)
    std = torch.clamp(k, min=1.0)

    factor = torch.floor(div(I32_MAX, std))
    y = torch.floor(y * factor / 2.0)

    bias_int = torch.floor(div(div(beta, gamma), base_scale))
    q_out = y + bias_int
    scale_out = gamma * base_scale
    return q_out, scale_out
