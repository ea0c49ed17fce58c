"""ShiftGELU: integer-only GELU via the sigmoid approximation.

Counterpart of ``ivit_tpu/ops/shiftgelu.py:shiftgelu``:
``GELU(x) ≈ x · σ(1.702·x)`` with the sigmoid as a two-term shift-exp
softmax, in its row-max form (the reference spec) and its elementwise
stable form (``stable=True``, ``m = max(x, 0)`` per element). The two
forms are value-different; the artifact records which one a model runs.
"""

from __future__ import annotations

import torch

from .interp import DEPLOY, I32_MAX, Interp, div
from .shiftexp import int_exp_shift


def shiftgelu(
    q: torch.Tensor,
    scale: torch.Tensor,
    out_bits: int = 8,
    n: int = 23,
    stable: bool = False,
    interp: Interp = DEPLOY,
    row_max=None,
):
    """Integer GELU of integer-valued float32 ``q`` at ``scale``.

    Returns ``(q_out, scale_out)``, ``scale_out = scale / 2^(out_bits−1)``.
    The sigmoid's scale is detached; ``scale_out`` is not. ``row_max``
    takes the row-max form's max over the last dimension (keepdim) where
    a tensor-parallel rank holds only some of the row's columns
    (``parallel.mesh.ModelAxis.row_max``); by default ``torch.amax``.
    """
    sig_scale = scale.detach() * 1.702
    if stable:
        neg_abs = torch.minimum(q, -q)  # −|x| ≤ 0
        exp_int, _ = int_exp_shift(neg_abs, sig_scale, n, interp)  # e^(−|x|)
        x0 = torch.floor(div(-1.0, sig_scale))
        e0 = (-x0) * 2.0**n  # exp_int(0) = p·2^n
        exp_sum = interp.clip(exp_int + e0, 1.0, I32_MAX)
        factor = interp.floor(div(I32_MAX, exp_sum))
        numer = torch.where(q >= 0.0, e0, exp_int)
        sigmoid_int = interp.floor(numer * factor / 2.0 ** (32 - out_bits))
    else:
        q_max = torch.amax(q, dim=-1, keepdim=True) if row_max is None else row_max(q)
        exp_int, _ = int_exp_shift(q - q_max, sig_scale, n, interp)  # e^(x−max)
        exp_max, _ = int_exp_shift(-q_max, sig_scale, n, interp)  # e^(−max)
        # the upper clip must stay: an all-negative row makes −max > 0
        # and exp_max saturates at 2^31−1
        exp_sum = interp.clip(exp_int + exp_max, 1.0, I32_MAX)
        factor = interp.floor(div(I32_MAX, exp_sum))
        sigmoid_int = interp.floor(exp_int * factor / 2.0 ** (32 - out_bits))
    q_out = q * sigmoid_int
    scale_out = scale * (1.0 / 2.0 ** (out_bits - 1))
    return q_out, scale_out
