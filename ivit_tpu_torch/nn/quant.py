"""Quantized layers for QAT (torch modules over ``QTensor``).

Counterpart of ``ivit_tpu/nn/quant.py``:

* ``QuantAct`` — EMA range tracker and requantizer, with the
  dual-scale residual merge (``identity``). Its range lives in the
  buffers ``min_val`` and ``max_val`` (flax's ``quant_stats``
  collection); ``update_stats=True`` moves them.
* ``QuantLinear`` — per-out-channel int8 weights recomputed from the
  live kernel on every call, the bias quantized at ``w_scale · s_in``,
  an exact int8 forward dot. The kernel is stored ``(in, out)`` as flax
  stores it.
* ``quant_matmul`` — the exact activation·activation product (at most
  16 × 8 bits).
* ``QuantPatchEmbed`` — the stride = kernel patch convolution as
  space-to-depth and one ``QuantLinear``.
* ``IntLayerNorm``, ``IntGELU``, ``IntSoftmax`` — the integer ops as
  modules.

The exact dots run their forward on integers (``torch._int_mm``, or
float64 products of integers, which are exact below 2^53) and their
backward as float32 matmuls with TF32 off, as JAX's
``Precision.HIGHEST`` backward does. ``QuantConv2d`` waits: no model
uses it.
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn

from ..core.qtensor import QTensor
from ..core.quantizers import symmetric_scale, weight_scale
from ..core.ste import quantize
from ..ops import int_layernorm, requantize, shiftgelu, shiftmax
from ..ops.interp import SIM
from ..ops.intmm import int8_matmul

_TRUNC_STD = 0.87962566103423978  # std of a unit normal truncated to ±2


def trunc_normal_(t: torch.Tensor, std: float, generator: torch.Generator | None = None) -> torch.Tensor:
    """flax's ``truncated_normal(stddev)``: a unit normal truncated to
    ±2, rescaled so that the draw has standard deviation ``std``."""
    s = std / _TRUNC_STD
    return nn.init.trunc_normal_(t, 0.0, s, -2.0 * s, 2.0 * s, generator=generator)


class QuantAct(nn.Module):
    """Activation (re)quantizer with EMA range tracking.

    ``x`` is a raw float tensor (input quantization) or a ``QTensor``
    (requantization); ``identity`` merges a residual branch held at
    another scale. The first update assigns the batch's range (the
    ``min == max`` sentinel of a fresh module), later ones move it by
    ``momentum``.
    """

    def __init__(self, bits: int = 8, momentum: float = 0.95):
        super().__init__()
        self.bits, self.momentum = bits, momentum
        self.register_buffer("min_val", torch.zeros((), dtype=torch.float32))
        self.register_buffer("max_val", torch.zeros((), dtype=torch.float32))

    def forward(self, x, identity: QTensor | None = None, update_stats: bool = False) -> QTensor:
        is_q = isinstance(x, QTensor)
        real = x.dequantize() if is_q else x.to(torch.float32)
        if identity is not None:
            real = real + identity.dequantize()
        if update_stats:
            with torch.no_grad():
                cur_min, cur_max = torch.aminmax(real.detach())
                first = self.min_val == self.max_val
                m = self.momentum
                new_min = torch.where(first, cur_min, m * self.min_val + (1 - m) * cur_min)
                new_max = torch.where(first, cur_max, m * self.max_val + (1 - m) * cur_max)
                self.min_val.copy_(new_min)
                self.max_val.copy_(new_max)
        scale = symmetric_scale(self.min_val, self.max_val, self.bits)
        if not is_q:
            q = quantize(real, scale, self.bits)
        else:
            q = requantize(
                x.q, x.scale, scale, self.bits,
                identity_q=None if identity is None else identity.q,
                identity_scale=None if identity is None else identity.scale,
                interp=SIM,
            )
        return QTensor(q, scale, self.bits)


@contextlib.contextmanager
def _fp32_highest():
    """Float32 matmuls in true float32 (no TF32) for the block, as JAX's
    ``Precision.HIGHEST``; the process's setting is restored after."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


class _ExactInt8Dot(torch.autograd.Function):
    """(..., K) int8-valued x @ (K, N) int8-valued w [+ int32-valued b]:
    forward a true int8 GEMM with the bias added in int32, as the deploy
    engine's accumulator; backward float32 matmuls."""

    @staticmethod
    def forward(x, w, b):
        acc = int8_matmul(x.reshape(-1, x.shape[-1]).to(torch.int8), w.to(torch.int8))
        if b is not None:
            acc = acc + b.to(torch.int32)
        return acc.to(torch.float32).reshape(*x.shape[:-1], w.shape[1])

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, w, b = inputs
        ctx.has_bias = b is not None
        ctx.save_for_backward(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1])
        with _fp32_highest():
            dx = torch.matmul(g, w.T)
            dw = torch.matmul(x.reshape(-1, x.shape[-1]).T, g2)
        return dx, dw, (g2.sum(0) if ctx.has_bias else None)


def exact_int8_dot_bias(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x: (..., K) int8-valued float32; w: (K, N) int8-valued; b: (N,)
    int32-valued. The exact int32 ``x @ w + b`` as float32."""
    return _ExactInt8Dot.apply(x, w, b)


def exact_int8_dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Bias-free variant of :func:`exact_int8_dot_bias`."""
    return _ExactInt8Dot.apply(x, w, None)


class _ExactIntMatmul(torch.autograd.Function):
    """Batched ``a @ b`` over the last two axes of integer-valued float32
    carriers, exact: float64 products and sums of integers are exact
    below 2^53 (|a| < 2^15, |b| ≤ 2^7 and K < 2^31), then one rounding to
    float32, as JAX's int32 result converts. Backward float32 matmuls."""

    @staticmethod
    def forward(a, b):
        return torch.matmul(a.to(torch.float64), b.to(torch.float64)).to(torch.float32)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        with _fp32_highest():
            return torch.matmul(g, b.transpose(-1, -2)), torch.matmul(a.transpose(-1, -2), g)


def exact_int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact batched product of an 8- or 16-bit-valued carrier ``a`` with
    an 8-bit-valued carrier ``b``. JAX's ``exact_int_matmul_8x8`` (one
    int8 dot) and ``exact_int_matmul_16x8`` (a base-256 split into two
    int8 dots plus ``128·Σb``) give these integers; one float64 product
    gives both."""
    return _ExactIntMatmul.apply(a, b)


def quant_matmul(a: QTensor, b: QTensor) -> QTensor:
    """Integer activation·activation matmul over the last two axes, at
    the scale ``s_a · s_b``. The ViT's operands are 8 × 8 bits (q·kᵀ,
    attn·v at 8-bit Shiftmax) or 16 × 8 (attn·v at 16-bit); wider ones
    raise (JAX's float32 fallback for them is not ported)."""
    if a.bits > 16 or b.bits > 8:
        raise ValueError(f"quant_matmul takes at most 16 x 8-bit operands, got {a.bits} x {b.bits}")
    return QTensor(exact_int_matmul(a.q, b.q), a.scale * b.scale, 32)


class QuantLinear(nn.Module):
    """Dense layer with per-out-channel symmetric int8 weights; the
    output is the int32-valued accumulator at the per-channel scale
    ``w_scale · s_in`` (a ``QuantAct`` after it requantizes)."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 weight_bits: int = 8, bias_bits: int = 32):
        super().__init__()
        self.weight_bits, self.bias_bits = weight_bits, bias_bits
        self.kernel = nn.Parameter(trunc_normal_(torch.empty(in_features, features), 0.02))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x: QTensor) -> QTensor:
        w_scale = weight_scale(self.kernel.T, self.weight_bits)  # (out,)
        w_int = quantize(self.kernel, w_scale, self.weight_bits)
        out_scale = w_scale * x.scale.detach()
        if self.bias is not None:
            b_int = quantize(self.bias, out_scale, self.bias_bits)
            y = exact_int8_dot_bias(x.q, w_int, b_int)
        else:
            y = exact_int8_dot(x.q, w_int)
        return QTensor(y, out_scale, 32)


class QuantPatchEmbed(nn.Module):
    """Patch embedding as space-to-depth and one ``QuantLinear``
    (``proj``) on NHWC input; the kernel rows are ordered (ph, pw, c)."""

    def __init__(self, patch_size: int = 16, in_chans: int = 3, features: int = 768,
                 weight_bits: int = 8, bias_bits: int = 32):
        super().__init__()
        self.patch_size = patch_size
        self.proj = QuantLinear(patch_size * patch_size * in_chans, features,
                                weight_bits=weight_bits, bias_bits=bias_bits)

    def forward(self, x: QTensor) -> QTensor:
        B, H, W, C = x.shape
        p = self.patch_size
        gh, gw = H // p, W // p
        q = x.q.reshape(B, gh, p, gw, p, C).permute(0, 1, 3, 2, 4, 5).reshape(B, gh * gw, p * p * C)
        return self.proj(QTensor(q, x.scale, x.bits))


class IntLayerNorm(nn.Module):
    """I-LayerNorm: γ (``scale``) folds into the differentiable
    per-channel output scale, β (``bias``) into an integer bias."""

    def __init__(self, features: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: QTensor) -> QTensor:
        q, s = int_layernorm(x.q, self.scale, self.bias, interp=SIM)
        return QTensor(q, s, 32)


class IntGELU(nn.Module):
    """ShiftGELU; ``stable`` selects the elementwise-stable form."""

    def __init__(self, out_bits: int = 8, stable: bool = False):
        super().__init__()
        self.out_bits, self.stable = out_bits, stable

    def forward(self, x: QTensor) -> QTensor:
        q, s = shiftgelu(x.q, x.scale, out_bits=self.out_bits, stable=self.stable, interp=SIM)
        return QTensor(q, s, 32)


class IntSoftmax(nn.Module):
    """Shiftmax at ``out_bits`` output precision."""

    def __init__(self, out_bits: int = 16):
        super().__init__()
        self.out_bits = out_bits

    def forward(self, x: QTensor) -> QTensor:
        q, s = shiftmax(x.q, x.scale, out_bits=self.out_bits, interp=SIM)
        return QTensor(q, s, self.out_bits)
