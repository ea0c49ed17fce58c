"""Shiftmax: integer-only softmax.

Counterpart of ``ivit_tpu/ops/shiftmax.py:shiftmax`` without its
``mask`` argument (no JAX model passes one: the Swin model adds its mask
to the scores itself, ``ivit_tpu/models/swin.py:141-151``) and the TPU
pass-boundary knobs (``q_max``,
``split_normalize``, ``static_p``, ``packed_exp``, ``col_valid``):
max-subtracted shift-exp, an exact row sum, normalization by
``⌊(2^31−1)/Σ⌋``, output at the fixed scale ``1/2^(bits−1)``.
"""

from __future__ import annotations

import torch

from .interp import DEPLOY, I32_MAX, Interp, div, f32
from .shiftexp import int_exp_shift


def shiftmax(q: torch.Tensor, scale: torch.Tensor, out_bits: int = 8, n: int = 15, interp: Interp = DEPLOY):
    """Integer softmax over the last axis of integer-valued float32 ``q``.

    Returns ``(q_out, scale_out)`` with ``scale_out = 1/2^(out_bits−1)``.
    """
    q = q - torch.amax(q, dim=-1, keepdim=True)
    exp_int, _ = int_exp_shift(q, scale, n, interp)
    exp_sum = interp.clip(_exact_sum_lastdim(exp_int, interp), 1.0, I32_MAX)
    # the final 2^-(32-bits) shift folded into the per-row factor (exact)
    factor = interp.floor(div(I32_MAX, exp_sum)) * (1.0 / 2.0 ** (32 - out_bits))
    q_out = interp.floor(exp_int * factor)
    scale_out = f32(1.0 / 2.0 ** (out_bits - 1), q.device)
    return q_out, scale_out


def _exact_sum_lastdim(exp_int: torch.Tensor, interp: Interp = DEPLOY) -> torch.Tensor:
    """Row sum of shift-exp values with the spec's fixed rounding points.

    Rows of ≤ 256 columns: split at 2^16; both partial sums stay below
    2^24, so they are exact in any order, and the one recombining add
    rounds once. Longer rows (≤ 4096): three limbs split at 2^12 and
    the fixed two-add recombine tree, which rounds twice — exactly as
    ``ivit_tpu/ops/shiftmax.py:_exact_sum_lastdim`` does.
    """
    n_row = exp_int.shape[-1]
    if n_row <= 256:
        hi = interp.floor(exp_int * (1.0 / 2.0**16))
        lo = exp_int - hi * 2.0**16
        return hi.sum(-1, keepdim=True) * 2.0**16 + lo.sum(-1, keepdim=True)
    if n_row > 4096:
        raise ValueError(f"exact shift-exp row sum supports rows <= 4096, got {n_row}")
    l2 = interp.floor(exp_int * (1.0 / 2.0**24))
    rem = exp_int - l2 * 2.0**24
    l1 = interp.floor(rem * (1.0 / 2.0**12))
    l0 = rem - l1 * 2.0**12
    s2 = l2.sum(-1, keepdim=True)
    s1 = l1.sum(-1, keepdim=True)
    s0 = l0.sum(-1, keepdim=True)
    return (s2 * 2.0**12 + s1) * 2.0**12 + s0
