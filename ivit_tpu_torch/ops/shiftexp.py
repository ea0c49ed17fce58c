"""Shift-based integer exponential (the I-ViT "shift-exp" trick).

Counterpart of ``ivit_tpu/ops/shiftexp.py:int_exp_shift`` with every
guard kept. The JAX deploy engine's ``static_p`` guard elisions are
value-identical, so the port leaves them out.
"""

from __future__ import annotations

import torch

from .interp import DEPLOY, I32_MAX, Interp, div


def int_exp_shift(q: torch.Tensor, scale: torch.Tensor, n: int, interp: Interp = DEPLOY):
    """Integer shift-exp of integer values ``q`` (≤ 0) held at ``scale``.

    Returns ``(exp_int, exp_scale)`` with ``exp_scale = scale / 2^n``;
    ``exp_int`` is integer-valued float32 in ``[0, 2^31]``. No gradient
    reaches ``scale``.
    """
    scale = scale.detach()
    # x * log2(e) ~= x + x/2 - x/16 (q/2 and q/16 are exact in f32)
    q = q + interp.floor(q / 2.0) - interp.floor(q / 16.0)
    # x0 = floor(-1/scale): the integer representing -1 (negative)
    x0 = torch.floor(div(-1.0, scale))
    q = torch.maximum(q, n * x0)
    qt = interp.floor(div(q, x0))
    r = q - x0 * qt
    # (r/2 - x0) * 2^(n-qt) == (r - 2*x0) * 2^(n-qt-1)
    exp_int = interp.floor((r - 2.0 * x0) * interp.exp2(n - 1.0 - qt))
    exp_int = interp.clip(exp_int, 0.0, I32_MAX)
    return exp_int, scale / 2.0**n
