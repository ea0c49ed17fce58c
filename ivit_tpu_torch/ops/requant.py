"""Requantization.

Counterpart of ``ivit_tpu/ops/requant.py:requantize`` and of the deploy
engine's ``_requant`` epilogue (``ivit_tpu/deploy/engine.py:53``), which
takes a precomputed float32 ratio, and of its ``_requant_strict``
(``:85-97``), which takes the ratio's dyadic pair (``core.dyadic``).
"""

from __future__ import annotations

import torch

from ..core.dyadic import Dyadic, dyadic_requant
from ..core.quantizers import int_range
from .interp import div

INT8 = (-128, 127)
INT16 = (-(2**15), 2**15 - 1)


def requant(acc: torch.Tensor, ratio: torch.Tensor | Dyadic, lo: int, hi: int) -> torch.Tensor:
    """``clip(round(acc·ratio), lo, hi)`` as integer-valued float32;
    ``acc`` (any integer or float dtype) is converted to float32 first,
    rounding to nearest above 2^24 exactly as the JAX engine does. A
    ``Dyadic`` ratio takes the strict path instead: the exact integer
    multiply and shift of integer-valued ``acc`` (``core.dyadic``)."""
    if isinstance(ratio, Dyadic):
        return torch.clamp(dyadic_requant(acc.to(torch.int32), ratio), lo, hi).to(torch.float32)
    return torch.clamp(torch.round(acc.to(torch.float32) * ratio), lo, hi)


def requantize(
    q: torch.Tensor,
    s_in: torch.Tensor,
    s_out: torch.Tensor,
    bits: int,
    identity_q: torch.Tensor | None = None,
    identity_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """Requantize ``q`` from ``s_in`` to ``s_out``, optionally merging a
    residual ``identity_q`` held at ``identity_scale`` (the dual-scale
    residual add)."""
    out = torch.round(q * div(s_in, s_out))
    if identity_q is not None:
        out = out + torch.round(identity_q * div(identity_scale, s_out))
    lo, hi = int_range(bits)
    return torch.clamp(out, lo, hi)
