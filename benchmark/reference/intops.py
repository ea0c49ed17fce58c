"""The integer-only operators of I-ViT (arXiv:2207.01405), in plain torch.

A frozen copy of the inference arithmetic the served models compute:
requantization, the shift-based exponential, Shiftmax, ShiftGELU (its
row-max and its elementwise-stable form) and I-LayerNorm, on
integer-valued float32 carriers. Every expression keeps its operand
order and its rounding points, so that the same integers come out on any
device. It imports nothing of the program under test.
"""

from __future__ import annotations

import math

import torch

INT8 = (-128, 127)
INT16 = (-(2**15), 2**15 - 1)
I32_MAX = 2.0**31 - 1.0  # rounds to 2^31 in float32
SHIFTMAX_N = 15  # the shift-exp precision of the attention Shiftmax
_F32_EPS = float(torch.finfo(torch.float32).eps)
_NEWTON_ITERS = 10


def scalar(value, device) -> torch.Tensor:
    """``value`` as a float32 scalar tensor on ``device``."""
    return torch.tensor(value, dtype=torch.float32, device=device)


def div(num, den) -> torch.Tensor:
    """Correctly rounded float32 division: a Python-number operand
    becomes a float32 tensor first (a tensor divided by a Python number
    is a reciprocal multiply on the card, which rounds otherwise)."""
    like = den if isinstance(den, torch.Tensor) else num
    if not isinstance(num, torch.Tensor):
        num = scalar(num, like.device)
    if not isinstance(den, torch.Tensor):
        den = scalar(den, like.device)
    return torch.div(num, den)


def int_range(bits: int) -> tuple[int, int]:
    n = 2 ** (bits - 1) - 1
    return -n - 1, n


def symmetric_scale(min_val: torch.Tensor, max_val: torch.Tensor, bits: int) -> torch.Tensor:
    """``max(|min|, max) / (2^(b−1) − 1)``, at least float32's eps."""
    n = 2 ** (bits - 1) - 1
    max_abs = torch.maximum(-min_val, max_val).to(torch.float32)
    return torch.clamp(torch.div(max_abs, scalar(float(n), max_abs.device)), min=_F32_EPS)


def weight_scale(w_out_first: torch.Tensor, bits: int) -> torch.Tensor:
    """Per-output-channel symmetric scale of a weight (output axis first)."""
    v = w_out_first.reshape(w_out_first.shape[0], -1)
    return symmetric_scale(torch.amin(v, dim=1), torch.amax(v, dim=1), bits)


def quantize(x: torch.Tensor, scale: torch.Tensor, bits: int) -> torch.Tensor:
    """``clip(round(x / scale))`` at ``bits``, integer-valued float32."""
    return torch.clamp(torch.round(torch.div(x, scale)), *int_range(bits))


def requant(acc: torch.Tensor, ratio: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """``clip(round(float32(acc) · ratio))``, integer-valued float32."""
    return torch.clamp(torch.round(acc.to(torch.float32) * ratio), lo, hi)


def requantize(q, s_in, s_out, bits, identity_q=None, identity_scale=None) -> torch.Tensor:
    """``q`` from scale ``s_in`` to ``s_out``, with an optional residual
    ``identity_q`` at ``identity_scale`` merged (the dual-scale add)."""
    out = torch.round(q * div(s_in, s_out))
    if identity_q is not None:
        out = out + torch.round(identity_q * div(identity_scale, s_out))
    return torch.clamp(out, *int_range(bits))


def exact_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The exact product of integer-valued tensors (float64 is exact
    below 2^53), as float64."""
    return torch.matmul(a.to(torch.float64), b.to(torch.float64))


def int8_gemm(x: torch.Tensor, w: torch.Tensor, weight_bits: int = 8) -> torch.Tensor:
    """(M, K) int8-valued x @ (K, N) int8 w → int32, exact. ``weight_bits``
    below 8 rounds w to that many bits first (its scale times 2^(8−bits)):
    the lower-precision control, never the reference."""
    if weight_bits < 8:
        step = 2 ** (8 - weight_bits)
        lo, hi = int_range(weight_bits)
        w = torch.clamp(torch.round(w.to(torch.float32) / step), lo, hi) * step
    return exact_matmul(x, w).to(torch.int32)


def exp2_int(k: torch.Tensor) -> torch.Tensor:
    """Exact ``2^k`` for integer-valued float32 ``k`` ≥ −126, written into
    the float32 exponent field."""
    return torch.bitwise_left_shift(k.to(torch.int32) + 127, 23).view(torch.float32)


def int_exp_shift(q: torch.Tensor, scale: torch.Tensor, n: int) -> torch.Tensor:
    """Shift-exp of integer ``q`` ≤ 0 at ``scale``: integer-valued float32
    in [0, 2^31] at ``scale / 2^n``."""
    q = q + torch.floor(q / 2.0) - torch.floor(q / 16.0)  # x·log2(e) ≈ x + x/2 − x/16
    x0 = torch.floor(div(-1.0, scale))  # the integer standing for −1
    q = torch.maximum(q, n * x0)
    qt = torch.floor(div(q, x0))
    r = q - x0 * qt
    exp_int = torch.floor((r - 2.0 * x0) * exp2_int(n - 1.0 - qt))
    return torch.clamp(exp_int, 0.0, I32_MAX)


def _exact_row_sum(exp_int: torch.Tensor) -> torch.Tensor:
    """Row sum of shift-exp values (rows ≤ 256) split at 2^16: both
    partial sums stay below 2^24, exact in any order; one rounding."""
    if exp_int.shape[-1] > 256:
        raise ValueError("the exact shift-exp row sum takes rows of at most 256")
    hi = torch.floor(exp_int * (1.0 / 2.0**16))
    lo = exp_int - hi * 2.0**16
    return hi.sum(-1, keepdim=True) * 2.0**16 + lo.sum(-1, keepdim=True)


def shiftmax(q: torch.Tensor, scale: torch.Tensor, out_bits: int = 8, n: int = SHIFTMAX_N) -> torch.Tensor:
    """Integer softmax over the last axis, at scale ``1/2^(out_bits−1)``."""
    q = q - torch.amax(q, dim=-1, keepdim=True)
    exp_int = int_exp_shift(q, scale, n)
    exp_sum = torch.clamp(_exact_row_sum(exp_int), 1.0, I32_MAX)
    factor = torch.floor(div(I32_MAX, exp_sum)) * (1.0 / 2.0 ** (32 - out_bits))
    return torch.floor(exp_int * factor)


def shiftgelu(q: torch.Tensor, scale: torch.Tensor, stable: bool, out_bits: int = 8, n: int = 23) -> torch.Tensor:
    """Integer GELU ``x·σ(1.702x)`` of ``q`` at ``scale``; the result is at
    ``scale / 2^(out_bits−1)``. ``stable`` takes the elementwise-stable
    sigmoid, else the row-max form over the last axis."""
    sig_scale = scale * 1.702
    if stable:
        neg_abs = torch.minimum(q, -q)
        exp_int = int_exp_shift(neg_abs, sig_scale, n)
        x0 = torch.floor(div(-1.0, sig_scale))
        e0 = (-x0) * 2.0**n
        exp_sum = torch.clamp(exp_int + e0, 1.0, I32_MAX)
        factor = torch.floor(div(I32_MAX, exp_sum))
        numer = torch.where(q >= 0.0, e0, exp_int)
        sigmoid_int = torch.floor(numer * factor / 2.0 ** (32 - out_bits))
    else:
        q_max = torch.amax(q, dim=-1, keepdim=True)
        exp_int = int_exp_shift(q - q_max, sig_scale, n)
        exp_max = int_exp_shift(-q_max, sig_scale, n)
        exp_sum = torch.clamp(exp_int + exp_max, 1.0, I32_MAX)
        factor = torch.floor(div(I32_MAX, exp_sum))
        sigmoid_int = torch.floor(exp_int * factor / 2.0 ** (32 - out_bits))
    return q * sigmoid_int


def _exact_stats(q: torch.Tensor):
    """(Σq as int32, Σq² recombined in float32) over the last axis, with
    q = a·2^8 + b split so that every int32 partial sum is exact."""
    d = q.shape[-1]
    qi = q.to(torch.int32)
    a = qi >> 8
    b = qi & 255
    s_q = qi.sum(-1, keepdim=True, dtype=torch.int32)
    s_bb = (b * b).sum(-1, keepdim=True, dtype=torch.int32)
    merge_limit = (2**31 - 1) // (128 * 128 * 128 + 128 * 256)
    if d <= min(1000, merge_limit):
        s_t = (a * a * 128 + a * b).sum(-1, keepdim=True, dtype=torch.int32)
        return s_q, s_t.to(torch.float32) * 2.0**9 + s_bb.to(torch.float32)
    s_aa = (a * a).sum(-1, keepdim=True, dtype=torch.int32)
    s_ab = (a * b).sum(-1, keepdim=True, dtype=torch.int32)
    sq2 = s_aa.to(torch.float32) * 2.0**16 + s_ab.to(torch.float32) * 2.0**9 + s_bb.to(torch.float32)
    return s_q, sq2


def layernorm_int(q: torch.Tensor) -> torch.Tensor:
    """I-LayerNorm's integer output with γ = 1 and β = 0 over the last
    axis: exact statistics, ten Newton steps of the integer square root,
    the factor ⌊(2^31−1)/std⌋."""
    d = q.shape[-1]
    s_q, sq2 = _exact_stats(q)
    sum_f = s_q.to(torch.float32)
    mean = torch.round(div(sum_f, float(d)))
    var = torch.clamp(sq2 - 2.0 * mean * sum_f + d * mean * mean, min=0.0)
    y = q.to(torch.float32) - mean
    k = torch.full_like(var, 2.0**16)
    for _ in range(_NEWTON_ITERS):
        k = torch.floor((k + torch.floor(div(var, k))) / 2.0)
    factor = torch.floor(div(I32_MAX, torch.clamp(k, min=1.0)))
    return torch.floor(y * factor / 2.0)


def layernorm_scale(gamma: torch.Tensor) -> torch.Tensor:
    """I-LayerNorm's per-channel output scale ``γ·√D/2^30``."""
    return gamma * (math.sqrt(gamma.shape[0]) / 2.0**30)


def layernorm_bias(gamma: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """β folded into the integer bias ``⌊(β/γ)/base⌋``, base = √D/2^30."""
    base = scalar(math.sqrt(gamma.shape[0]) / 2.0**30, gamma.device)
    return torch.floor(div(div(beta, gamma), base))


def layernorm_requant(x: torch.Tensor, bias_int: torch.Tensor, ratio: torch.Tensor) -> torch.Tensor:
    """I-LayerNorm, the folded β and the per-channel requant to int8."""
    return requant(layernorm_int(x) + bias_int, ratio, *INT8)
