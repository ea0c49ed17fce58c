"""Dyadic (multiply + shift) requantization.

Counterpart of ``ivit_tpu/core/dyadic.py``: a requantization ratio
``r = S_in / S_out`` becomes a 31-bit integer mantissa ``m`` and a
power-of-two exponent ``e`` (``r ≈ m / 2^e``), and ``z · r`` becomes the
exact integer ``round_half_away(z · m / 2^e)`` — the integer-ISA
semantics of the reference's ``batch_frexp`` + ``fixedpoint_mul``, used
by the engine's ``strict_dyadic`` mode. ``requant_f32`` is the canonical
float32 spec every other requant follows.

JAX assembles the 63-bit product ``z · m`` from 16-bit limbs in uint32
lanes (a TPU has no 64-bit integers); here it is one int64 product. The
integers are the same, wrap-around included: the result is the low 32
bits of the shifted product, read as int32 and then signed, as the limb
form computes it (so ``z = −2^31`` has magnitude 2^31).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

_MAX_BIT = 31
_U32 = 0xFFFFFFFF


class Dyadic(NamedTuple):
    """A ratio as its int32 mantissa ``m`` and exponent ``e``."""

    m: torch.Tensor
    e: torch.Tensor


def dyadic_decompose(r: torch.Tensor, max_bit: int = _MAX_BIT) -> Dyadic:
    """Decompose positive ratio(s) ``r`` into ``(m, e)`` with r ≈ m / 2^e.

    ``m`` is int32 in ``[2^(max_bit−1), 2^max_bit)``; the mantissa rounds
    half up in float32, as ``jnp.frexp`` followed by ``floor(· + 0.5)``
    does on the JAX side."""
    frac, exp = torch.frexp(r.to(torch.float32))  # r = frac · 2^exp, frac in [0.5, 1)
    m = torch.floor(frac * 2.0**max_bit + 0.5).to(torch.int32)
    e = (max_bit - exp).to(torch.int32)
    return Dyadic(m, e)


def _wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 ``x`` reduced modulo 2^32 into the int32 range (two's complement)."""
    return ((x + 2**31) & _U32) - 2**31


def dyadic_mul_exact(z: torch.Tensor, m: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """Exact integer ``round_half_away(z · m / 2^e)``.

    ``z``: int32 values. ``m``: int32 mantissa in [2^30, 2^31). ``e``:
    int32 exponent, clamped to [1, 62]. ``|z| · m + 2^(e−1)`` stays below
    2^63, so the int64 product is exact. Returns int32."""
    z = z.to(torch.int32).to(torch.int64)
    sign = torch.where(z < 0, -1, 1)
    ei = torch.clamp(e.to(torch.int64), 1, 62)
    prod = z.abs() * (m.to(torch.int64) & _U32)
    res = (prod + torch.bitwise_left_shift(torch.ones_like(ei), ei - 1)) >> ei
    return _wrap_i32(sign * _wrap_i32(res)).to(torch.int32)


def requant_f32(z: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Canonical requantization: round-half-to-even of ``z · r`` in
    float32 (``z`` an integer-valued carrier or an int32 accumulator).
    Returns float32 integer values; the caller clips."""
    return torch.round(z.to(torch.float32) * r.to(torch.float32))


def dyadic_requant(z: torch.Tensor, r: torch.Tensor | Dyadic) -> torch.Tensor:
    """Strict integer-only requantization of int32 ``z`` by ratio ``r``
    (float32, broadcasting against ``z``, or its ``Dyadic`` pair).
    Returns int32."""
    m, e = r if isinstance(r, Dyadic) else dyadic_decompose(r)
    return dyadic_mul_exact(z, m, e)
