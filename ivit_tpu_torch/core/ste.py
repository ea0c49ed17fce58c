"""Straight-through estimators, and the one symmetric quantizer.

Counterpart of ``ivit_tpu/core/ste.py``: ``round_ste`` and ``floor_ste``
round in the forward and pass the gradient through unchanged (the
``jax.custom_vjp`` pair becomes a ``torch.autograd.Function``), and
``quantize`` is the symmetric fake-quantizer whose gradient with respect
to ``x`` is ``1/scale`` (the scale is detached and the clamp masks no
gradient, as the reference's backward divides by the scale
unconditionally).
"""

from __future__ import annotations

import torch

from .quantizers import int_range


class _RoundSTE(torch.autograd.Function):
    @staticmethod
    def forward(x):
        return torch.round(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        return g


class _FloorSTE(torch.autograd.Function):
    @staticmethod
    def forward(x):
        return torch.floor(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        return g


def round_ste(x: torch.Tensor) -> torch.Tensor:
    """``round(x)`` (half to even), identity gradient."""
    return _RoundSTE.apply(x) if x.requires_grad else torch.round(x)


def floor_ste(x: torch.Tensor) -> torch.Tensor:
    """``floor(x)``, identity gradient."""
    return _FloorSTE.apply(x) if x.requires_grad else torch.floor(x)


def clip_ste(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """``clip(x, lo, hi)`` whose gradient is the identity, in the exact
    residue form ``sg(clipped) + (x − sg(x))``: its value is the clipped
    value bit for bit at any magnitude (``x − x`` is exactly 0), where
    the naive ``x + sg(clipped − x)`` cancels in float32 once
    ``|x| ≫ hi`` (at ``|x| ≈ 1.2e18`` it returns 0 for 2^31−1). The
    parentheses matter: ``(clipped + x) − x`` loses the clip below
    ``x``'s ulp.

    Without a gradient to carry it is the plain clamp (the same values
    for finite ``x``), as ``round_ste``, ``floor_ste`` and ``SIM.exp2``
    are their plain ops: with the residue form and the Functions on
    every call a DeiT-S SIM eval forward at batch 128 took 16% longer
    on an H100, with the Functions alone 5% (paired trainer turns; the
    benchmark's ``deit_s.train_b128`` cell now times the QAT step)."""
    clipped = torch.clamp(x, lo, hi)
    if not x.requires_grad:
        return clipped
    return clipped.detach() + (x - x.detach())


def quantize(x: torch.Tensor, scale: torch.Tensor, bits: int) -> torch.Tensor:
    """Symmetric quantization of ``x`` at ``scale`` (broadcasting) to
    ``bits``: ``clip(round(x / scale))`` as an integer-valued float32
    tensor, with the gradient ``1/scale`` with respect to ``x`` (round
    and clamp straight through, the scale detached). Without a gradient
    to carry it is the plain clamp of the rounded quotient."""
    lo, hi = int_range(bits)
    return clip_ste(round_ste(torch.div(x, scale.detach())), lo, hi)
