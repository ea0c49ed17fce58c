"""Scale computation for symmetric quantization.

Counterpart of ``ivit_tpu/core/quantizers.py`` plus the forward half of
``ivit_tpu/core/ste.py:quantize`` (inference only: no straight-through
gradient is needed yet).
"""

from __future__ import annotations

import torch

_F32_EPS = float(torch.finfo(torch.float32).eps)


def int_range(bits: int) -> tuple[int, int]:
    """Symmetric two's-complement range ``[-2^(b-1), 2^(b-1)-1]``."""
    n = 2 ** (bits - 1) - 1
    return -n - 1, n


def symmetric_scale(min_val: torch.Tensor, max_val: torch.Tensor, bits: int) -> torch.Tensor:
    """``scale = max(|min|, max) / (2^(b-1)-1)``, clamped to f32 eps."""
    n = 2 ** (bits - 1) - 1
    max_abs = torch.maximum(-min_val, max_val).to(torch.float32)
    scale = torch.div(max_abs, torch.tensor(float(n), device=max_abs.device))
    return torch.clamp(scale, min=_F32_EPS)


def per_channel_minmax(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-out-channel (first axis) min/max of a weight tensor."""
    v = w.reshape(w.shape[0], -1)
    return torch.amin(v, dim=1), torch.amax(v, dim=1)


def weight_scale(w_out_first: torch.Tensor, bits: int) -> torch.Tensor:
    """Per-out-channel symmetric scale."""
    mn, mx = per_channel_minmax(w_out_first)
    return symmetric_scale(mn, mx, bits)


def quantize(x: torch.Tensor, scale: torch.Tensor, bits: int) -> torch.Tensor:
    """Symmetric quantization of ``x`` at ``scale`` (broadcasting), as an
    integer-valued float32 tensor: ``clip(round(x / scale))``."""
    lo, hi = int_range(bits)
    return torch.clamp(torch.round(torch.div(x, scale)), lo, hi)
