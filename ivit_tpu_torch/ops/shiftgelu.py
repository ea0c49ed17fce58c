"""ShiftGELU: integer-only GELU via the sigmoid approximation (DEPLOY).

Counterpart of ``ivit_tpu/ops/shiftgelu.py:shiftgelu``:
``GELU(x) ≈ x · σ(1.702·x)`` with the sigmoid as a two-term shift-exp
softmax, in its row-max form (the reference spec) and its elementwise
stable form (``stable=True``, ``m = max(x, 0)`` per element). The two
forms are value-different; the artifact records which one a model runs.
"""

from __future__ import annotations

import torch

from .interp import I32_MAX, div
from .shiftexp import int_exp_shift


def shiftgelu(
    q: torch.Tensor,
    scale: torch.Tensor,
    out_bits: int = 8,
    n: int = 23,
    stable: bool = False,
):
    """Integer GELU of integer-valued float32 ``q`` at ``scale``.

    Returns ``(q_out, scale_out)``, ``scale_out = scale / 2^(out_bits−1)``.
    """
    sig_scale = scale * 1.702
    if stable:
        neg_abs = torch.minimum(q, -q)  # −|x| ≤ 0
        exp_int, _ = int_exp_shift(neg_abs, sig_scale, n)  # e^(−|x|)
        x0 = torch.floor(div(-1.0, sig_scale))
        e0 = (-x0) * 2.0**n  # exp_int(0) = p·2^n
        exp_sum = torch.clamp(exp_int + e0, 1.0, I32_MAX)
        factor = torch.floor(div(I32_MAX, exp_sum))
        numer = torch.where(q >= 0.0, e0, exp_int)
        sigmoid_int = torch.floor(numer * factor / 2.0 ** (32 - out_bits))
    else:
        q_max = torch.amax(q, dim=-1, keepdim=True)
        exp_int, _ = int_exp_shift(q - q_max, sig_scale, n)  # e^(x−max)
        exp_max, _ = int_exp_shift(-q_max, sig_scale, n)  # e^(−max)
        # the upper clip must stay: an all-negative row makes −max > 0
        # and exp_max saturates at 2^31−1
        exp_sum = torch.clamp(exp_int + exp_max, 1.0, I32_MAX)
        factor = torch.floor(div(I32_MAX, exp_sum))
        sigmoid_int = torch.floor(exp_int * factor / 2.0 ** (32 - out_bits))
    q_out = q * sigmoid_int
    scale_out = scale * (1.0 / 2.0 ** (out_bits - 1))
    return q_out, scale_out
