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
* ``QuantConv2d`` — a general NHWC convolution with per-out-channel
  int8 weights (no model uses it; the models' only convolution is the
  patch embedding): im2col and the exact int8 dot.
* ``IntLayerNorm``, ``IntGELU``, ``IntSoftmax`` — the integer ops as
  modules.

The exact dots run their forward on integers (``torch._int_mm``, or
float64 products of integers, which are exact below 2^53) and their
backward as float32 matmuls with TF32 off, as JAX's
``Precision.HIGHEST`` backward does. ``SIM_FAST_MATMUL`` (``quant_train
--fast-matmul``) turns that backward into JAX's ``Precision.DEFAULT`` on
the TPU: bf16-rounded operands summed in float32.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from ..core.qtensor import QTensor
from ..core.quantizers import per_channel_minmax, symmetric_scale, weight_scale
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


@dataclasses.dataclass(frozen=True)
class DataShard:
    """This process's share of a data-parallel step's global batch: rows
    ``[rank·b, (rank+1)·b)`` of ``size·b``, and ``reduce_range``, which
    takes this shard's ``(min, max)`` to the global batch's (on a model
    axis, ``parallel.tensor``, to the whole tensor's over every rank)."""

    rank: int
    size: int
    reduce_range: Callable[[torch.Tensor, torch.Tensor], tuple]


_SHARD: DataShard | None = None


@contextlib.contextmanager
def data_shard(shard: DataShard | None):
    """Run the block as one shard of a data-parallel step
    (``train.make_train_step`` with a mesh): every ``QuantAct`` range
    update takes the global batch's range, as JAX's ``jnp.min``/``max``
    over a data-sharded batch does, and the dropout and drop-path masks
    are drawn for the global batch (``nn.vit_blocks.keep_mask``). None
    leaves the block single-process."""
    global _SHARD
    prev, _SHARD = _SHARD, shard
    try:
        yield
    finally:
        _SHARD = prev


def current_shard() -> DataShard | None:
    """The ``data_shard`` in force, or None."""
    return _SHARD


@dataclasses.dataclass(frozen=True)
class LinearSplit:
    """How a ``QuantLinear`` of a tensor-parallel model
    (``parallel.tensor``) splits over the model axis: ``rows``
    (row-parallel: this rank holds input rows of the kernel, forms a
    partial int32 product that the model group sums, exact, and the bias
    is added once after the sum) or columns (its output columns: ``qkv``
    by heads, ``fc1``, the head by classes). ``seq`` is sequence
    parallelism: a column layer gathers its input's tokens, and a row
    layer keeps this rank's tokens of the sum (a reduce-scatter).
    ``axis`` is the mesh's ``parallel.mesh.ModelAxis``.

    Such a layer runs inside ``data_shard`` (the steps'
    ``parallel.batch_shard``, whose range reduction spans every rank),
    and raises outside it: a range taken over one rank's columns alone
    would be silently another model's."""

    axis: object
    rows: bool
    seq: bool = False


class QuantAct(nn.Module):
    """Activation (re)quantizer with EMA range tracking.

    ``x`` is a raw float tensor (input quantization) or a ``QTensor``
    (requantization); ``identity`` merges a residual branch held at
    another scale. The first update assigns the batch's range (the
    ``min == max`` sentinel of a fresh module), later ones move it by
    ``momentum``.

    ``hold_range`` (set by ``held_ranges``) turns the update off whatever
    ``update_stats`` says: a recompute (``nn.remat``) runs the module
    again on the range the forward's one update left, which is the range
    that forward quantized with. Inside ``data_shard`` the batch's range
    is the global batch's.
    """

    def __init__(self, bits: int = 8, momentum: float = 0.95):
        super().__init__()
        self.bits, self.momentum = bits, momentum
        self.hold_range = False
        self.register_buffer("min_val", torch.zeros((), dtype=torch.float32))
        self.register_buffer("max_val", torch.zeros((), dtype=torch.float32))

    def forward(self, x, identity: QTensor | None = None, update_stats: bool = False) -> QTensor:
        is_q = isinstance(x, QTensor)
        real = x.dequantize() if is_q else x.to(torch.float32)
        if identity is not None:
            real = real + identity.dequantize()
        if update_stats and not self.hold_range:
            with torch.no_grad():
                cur_min, cur_max = torch.aminmax(real.detach())
                if _SHARD is not None:
                    cur_min, cur_max = _SHARD.reduce_range(cur_min, cur_max)
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
def held_ranges(module: nn.Module):
    """Hold the range of every ``QuantAct`` in ``module`` for the block
    (``QuantAct.hold_range``); each is restored after."""
    acts = [m for m in module.modules() if isinstance(m, QuantAct)]
    before = [m.hold_range for m in acts]
    for m in acts:
        m.hold_range = True
    try:
        yield
    finally:
        for m, held in zip(acts, before):
            m.hold_range = held


# Set by ``quant_train --fast-matmul`` (JAX's ``SIM_FAST_MATMUL``): the
# exact dots' backward GEMMs take bf16-rounded operands and sum in
# float32, JAX's ``Precision.DEFAULT`` on the TPU; the forward stays
# integer-exact. It is read when a backward runs.
SIM_FAST_MATMUL = False


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


@contextlib.contextmanager
def _bf16_full_reduction():
    """cuBLAS sums bf16 GEMMs in float32 for the block (no reduced-
    precision split-K reduction); the process's setting is restored after."""
    matmul = torch.backends.cuda.matmul
    prev = matmul.allow_bf16_reduced_precision_reduction
    matmul.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        matmul.allow_bf16_reduced_precision_reduction = prev


def backward_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (a: (..., M, K); b: (K, N), or (..., K, N) with a's batch
    axes) for an exact dot's backward: float32 with TF32 off, or under
    ``SIM_FAST_MATMUL`` the operands rounded to bf16 and summed in float32
    (on the card a bf16 GEMM with a float32 result; on the CPU the
    rounded operands back in float32, whose products are exact)."""
    if not SIM_FAST_MATMUL:
        with _fp32_highest():
            return torch.matmul(a, b)
    a16, b16 = a.to(torch.bfloat16), b.to(torch.bfloat16)
    if not a.is_cuda:
        with _fp32_highest():
            return torch.matmul(a16.to(torch.float32), b16.to(torch.float32))
    with _bf16_full_reduction():
        if b.dim() == 2:
            out = torch.mm(a16.reshape(-1, a.shape[-1]), b16, out_dtype=torch.float32)
        else:
            out = torch.bmm(a16.reshape(-1, *a.shape[-2:]), b16.reshape(-1, *b.shape[-2:]), out_dtype=torch.float32)
    return out.reshape(*a.shape[:-1], b.shape[-1])


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
        dx = backward_matmul(g, w.T)
        dw = backward_matmul(x.reshape(-1, x.shape[-1]).T, g2)
        return dx, dw, (g2.sum(0) if ctx.has_bias else None)


def exact_int8_dot_bias(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x: (..., K) int8-valued float32; w: (K, N) int8-valued; b: (N,)
    int32-valued. The exact int32 ``x @ w + b`` as float32."""
    return _ExactInt8Dot.apply(x, w, b)


def exact_int8_dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Bias-free variant of :func:`exact_int8_dot_bias`."""
    return _ExactInt8Dot.apply(x, w, None)


class _RowParallelInt8Dot(torch.autograd.Function):
    """``_ExactInt8Dot`` of a row-parallel layer (``LinearSplit``): the
    partial int32 product summed over the model group (or reduce-
    scattered over tokens) before the bias and the float32 conversion, so
    the result is the whole product's bit for bit. Backward: the
    gradient, gathered over tokens under sequence parallelism, into this
    rank's input columns and kernel rows, and the whole bias."""

    @staticmethod
    def forward(ctx, x, w, b, split):
        acc = int8_matmul(x.reshape(-1, x.shape[-1]).to(torch.int8), w.to(torch.int8))
        acc = acc.reshape(*x.shape[:-1], w.shape[1])
        acc = split.axis.sum_tokens(acc) if split.seq else split.axis.sum(acc)
        if b is not None:
            acc = acc + b.to(torch.int32)
        ctx.save_for_backward(x, w)
        ctx.has_bias, ctx.split = b is not None, split
        return acc.to(torch.float32)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        if ctx.split.seq:
            g = ctx.split.axis.all_tokens(g.contiguous())
        g2 = g.reshape(-1, g.shape[-1])
        dx = backward_matmul(g, w.T)
        dw = backward_matmul(x.reshape(-1, x.shape[-1]).T, g2)
        return dx, dw, (g2.sum(0) if ctx.has_bias else None), None


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
        return backward_matmul(g, b.transpose(-1, -2)), backward_matmul(a.transpose(-1, -2), g)


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
    ``w_scale · s_in`` (a ``QuantAct`` after it requantizes).
    ``w_scale`` keeps the last forward's per-channel weight scale
    (detached; this rank's channels of a column-parallel layer), so a
    check can read the scale the layer quantized with."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 weight_bits: int = 8, bias_bits: int = 32):
        super().__init__()
        self.weight_bits, self.bias_bits = weight_bits, bias_bits
        self.kernel = nn.Parameter(trunc_normal_(torch.empty(in_features, features), 0.02))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None
        self.split: LinearSplit | None = None  # set by parallel.tensor
        self.w_scale: torch.Tensor | None = None

    def forward(self, x: QTensor) -> QTensor:
        split = self.split
        if split is None:
            w_scale = weight_scale(self.kernel.T, self.weight_bits)  # (out,)
        else:
            if _SHARD is None:
                raise RuntimeError("a tensor-parallel layer runs inside nn.quant.data_shard(parallel.batch_shard("
                                   "mesh)), as the train and eval steps run it")
            mn, mx = per_channel_minmax(self.kernel.T)
            if split.rows:  # each output channel's range spans every rank's input rows
                mn, mx = split.axis.max(torch.stack([-mn, mx])).unbind(0)
                mn = -mn
            else:
                x = x.replace(q=split.axis.gather_tokens(x.q) if split.seq else split.axis.copy(x.q))
            w_scale = symmetric_scale(mn, mx, self.weight_bits)
        self.w_scale = w_scale.detach()
        w_int = quantize(self.kernel, w_scale, self.weight_bits)
        out_scale = w_scale * x.scale.detach()
        b_int = None if self.bias is None else quantize(self.bias, out_scale, self.bias_bits)
        if split is not None and split.rows:
            y = _RowParallelInt8Dot.apply(x.q, w_int, b_int, split)
        elif b_int is not None:
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


class QuantConv2d(nn.Module):
    """General quantized NHWC convolution, per-out-channel int8 weights:
    the kernel ``(kh, kw, in, out)`` as flax stores it, the bias quantized
    at ``w_scale · s_in``, the output the int32-valued accumulator at
    that per-channel scale. ``padding`` is ``"VALID"`` or ``"SAME"``
    (XLA's: the extra row or column, if any, at the end).

    JAX convolves in float32 at ``HIGHEST`` on the integer values, which
    is exact while its sums stay below 2^24. Here im2col (``F.unfold``)
    and the exact int8 dot give the int32 sums at any size, so the two
    agree wherever JAX's are exact; the backward is the exact dot's
    (float32 with TF32 off) through ``F.unfold``'s."""

    def __init__(self, in_features: int, features: int, kernel_size: tuple, strides: tuple = (1, 1),
                 padding: str = "VALID", use_bias: bool = True, weight_bits: int = 8, bias_bits: int = 32):
        super().__init__()
        if padding not in ("VALID", "SAME"):
            raise ValueError(f"padding {padding!r}: VALID or SAME")
        self.kernel_size, self.strides, self.padding = tuple(kernel_size), tuple(strides), padding
        self.weight_bits, self.bias_bits = weight_bits, bias_bits
        kh, kw = self.kernel_size
        self.kernel = nn.Parameter(trunc_normal_(torch.empty(kh, kw, in_features, features), 0.02))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x: QTensor) -> QTensor:
        (kh, kw), (sh, sw) = self.kernel_size, self.strides
        w_scale = weight_scale(self.kernel.permute(3, 0, 1, 2), self.weight_bits)  # (out,)
        w_int = quantize(self.kernel, w_scale, self.weight_bits)
        out_scale = w_scale * x.scale.detach()

        q = x.q.permute(0, 3, 1, 2)  # NCHW for F.unfold
        B, C, H, W = q.shape
        if self.padding == "SAME":
            pads = []
            for n, k, s in ((W, kw, sw), (H, kh, sh)):
                total = max((-(-n // s) - 1) * s + k - n, 0)
                pads += [total // 2, total - total // 2]
            q = F.pad(q, pads)
        Ho, Wo = (q.shape[2] - kh) // sh + 1, (q.shape[3] - kw) // sw + 1
        cols = F.unfold(q, (kh, kw), stride=(sh, sw)).transpose(1, 2)  # (B, L, C·kh·kw), rows (c, i, j)
        w_mat = w_int.permute(2, 0, 1, 3).reshape(C * kh * kw, -1)
        if self.bias is not None:
            y = exact_int8_dot_bias(cols, w_mat, quantize(self.bias, out_scale, self.bias_bits))
        else:
            y = exact_int8_dot(cols, w_mat)
        return QTensor(y.reshape(B, Ho, Wo, -1), out_scale, 32)


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
        self.row_max = None  # the model axis's row max where the row is split (parallel.tensor)

    def forward(self, x: QTensor) -> QTensor:
        q, s = shiftgelu(x.q, x.scale, out_bits=self.out_bits, stable=self.stable, interp=SIM,
                         row_max=self.row_max)
        return QTensor(q, s, 32)


class IntSoftmax(nn.Module):
    """Shiftmax at ``out_bits`` output precision."""

    def __init__(self, out_bits: int = 16):
        super().__init__()
        self.out_bits = out_bits

    def forward(self, x: QTensor) -> QTensor:
        q, s = shiftmax(x.q, x.scale, out_bits=self.out_bits, interp=SIM)
        return QTensor(q, s, self.out_bits)
