"""Seeded model weights, drawn on the device in one call.

A model's float parameters are carved from one uniform draw of a
``torch.Generator`` on the device: weights as flax's
``truncated_normal(0.02)`` (a unit normal truncated to ±2, rescaled to
std 0.02) by the inverse normal CDF, biases and LayerNorm β as small
normals, LayerNorm γ as 1 plus a small normal, so every add on the path
sees nonzero values. The same seed gives the same weights on the same
device type.
"""

from __future__ import annotations

import math

import torch

_TRUNC_STD = 0.87962566103423978  # std of a unit normal truncated to ±2
_PHI_2 = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))  # Φ(2)


class Draws:
    """Hands out slices of one uniform draw, shaped and transformed."""

    def __init__(self, total: int, generator: torch.Generator, device):
        self.u = torch.rand(total, generator=generator, device=device, dtype=torch.float64)
        self.pos = 0

    def _take(self, shape) -> torch.Tensor:
        n = math.prod(shape)
        if self.pos + n > self.u.numel():
            raise ValueError("weight draws exhausted: the size count is wrong")
        u = self.u[self.pos:self.pos + n].reshape(shape)
        self.pos += n
        return u

    def trunc_normal(self, shape, std: float = 0.02) -> torch.Tensor:
        u = (1.0 - _PHI_2) + self._take(shape) * (2.0 * _PHI_2 - 1.0)  # uniform on [Φ(−2), Φ(2)]
        x = torch.erfinv(2.0 * u - 1.0) * math.sqrt(2.0)
        return (x * (std / _TRUNC_STD)).to(torch.float32)

    def normal(self, shape, std: float = 1.0) -> torch.Tensor:
        u = self._take(shape).clamp(1e-12, 1.0 - 1e-12)
        return (torch.erfinv(2.0 * u - 1.0) * (math.sqrt(2.0) * std)).to(torch.float32)

    def linear(self, k: int, n: int, bias: bool = True):
        return self.trunc_normal((k, n)), (self.normal((n,), 0.02) if bias else None)

    def norm(self, d: int):
        return 1.0 + self.normal((d,), 0.1), self.normal((d,), 0.02)


def linear_size(k: int, n: int, bias: bool = True) -> int:
    return k * n + (n if bias else 0)


def generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed`` (any non-negative
    integer below 2^64)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g
