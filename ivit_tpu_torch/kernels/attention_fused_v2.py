"""K2: fused integer attention with v2's value semantics.

Replaces ``ivit_tpu/kernels/attention_fused_v2.py:fused_int8_attention_v2``
(``pl.pallas_call`` at :140). The CUDA kernel is
``csrc/attention_fused_v2.cu``, the K2 mode of the int8 tensor-core
attention kernel it shares with K1 (``csrc/attention_mma.cuh``; the
design and what bounds it are in ``kernels/attention_fused.py``): the
per-element shift-exp clip elided (in the block's shift-exp table) and
an int32 row sum rounded once to float32. v2's float32 @V runs as K1's
exact integer product. The TPU kernel's per-image grid (all heads in a
1.4 MB VMEM scratch) does not fit a 227 KB Hopper block, so the grid is
batch·head × row tiles on the port's unpadded (B·H, N, hd) layout.

Each of v2's shortcuts is exact under its gate
``n_valid·⌈1/scale⌉·2^n < 2^31`` (``attention_fused_v2.py:124-128``),
which the wrapper enforces with ``ValueError``: the clip cannot bind and
the int32 sum cannot wrap. The f32 @V is exact at any scale: a row's
probabilities sum to at most (2^31−1)/2^(32−out_bits) < 2^15 and
|v| ≤ 128, so every partial sum stays below 2^22, and an integer product
gives the same values. Under the gate K2 therefore gives K1's integers.

``fused_int8_attention_v2_reference`` is the plain version, stated with
v2's chain on the K0 twin; the integer products run in float64 (exact).
The wrapper runs it for CPU tensors and launches the kernel for CUDA
tensors.
"""

from __future__ import annotations

import math

import torch

from ..ops import INT8, requant
from ..ops.interp import I32_MAX, f32
from . import _build
from . import _shiftmax_common as k0
from .attention_fused import SHIFTMAX_N, _check as _check_qkv


def scale_gate(n_valid: int, scale: float, n: int = SHIFTMAX_N) -> bool:
    """v2's gate ``n_valid·⌈1/scale⌉·2^n < 2^31``, in the JAX kernel's
    own float64 expression (``p = −⌊−1/scale⌋``)."""
    return n_valid * -math.floor(-1.0 / float(scale)) * 2.0**n < 2.0**31


def fused_int8_attention_v2_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    r1: float, scale: float, r_out: float, n_valid: int, out_bits: int = 16,
) -> torch.Tensor:
    """Plain torch K2 on (G, N, hd) int8 q, k, v; returns int8 (G, N, hd)."""
    dev = q.device
    attn = torch.matmul(q.to(torch.float64), k.to(torch.float64).transpose(-1, -2)).to(torch.float32)
    z = requant(attn, f32(r1, dev), *INT8)
    z = z - torch.amax(z, dim=-1, keepdim=True)
    valid = torch.ones_like(z, dtype=torch.bool)
    e = k0.shift_exp_rows(z, f32(scale, dev), SHIFTMAX_N, valid, clip_e=False)
    esum = e.to(torch.int32).sum(-1, keepdim=True, dtype=torch.int32).to(torch.float32)
    sm = torch.floor(e * k0.norm_factor(torch.clamp(esum, 1.0, I32_MAX), out_bits))
    # f32 @V, exact (every partial sum < 2^22); summed in float64 here so
    # that no TF32 setting can touch it
    ctx = torch.matmul(sm.to(torch.float64), v.to(torch.float64)).to(torch.float32)
    return requant(ctx, f32(r_out, dev), *INT8).to(torch.int8)


def _check(q, k, v, scale, n_valid, out_bits) -> None:
    _check_qkv(q, k, v, out_bits)
    N = q.shape[1]
    if n_valid != N:
        raise ValueError(f"n_valid={n_valid}: the layout is unpadded, so n_valid must equal N={N}")
    if not scale_gate(n_valid, scale):
        raise ValueError(
            f"scale {scale} fails the v2 gate n_valid*ceil(1/scale)*2^{SHIFTMAX_N} < 2^31 "
            f"(n_valid={n_valid}): the int32 row sum could wrap"
        )


@torch.library.custom_op(
    "ivit::fused_int8_attention_v2", mutates_args=(),
    schema="(Tensor q, Tensor k, Tensor v, float r1, float scale, float r_out, int out_bits) -> Tensor",
)
def _attention_v2_op(q, k, v, r1, scale, r_out, out_bits):
    if q.device.type == "cpu":
        return fused_int8_attention_v2_reference(q, k, v, r1, scale, r_out, q.shape[1], out_bits)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if any(t.data_ptr() % 4 for t in (q, k, v)):
        raise ValueError("q, k, v must start on 4-byte boundaries (the kernel loads words)")
    lib = _build.load()
    G, N, hd = q.shape
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = lib.ivit_fused_int8_attention_v2(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            G, N, hd, r1, scale, r_out, SHIFTMAX_N, out_bits, stream,
        )
    _build.check(err, "fused_int8_attention_v2")
    fused_int8_attention_v2.launches += 1
    return out


@_attention_v2_op.register_fake
def _(q, k, v, r1, scale, r_out, out_bits):
    return torch.empty_like(q)


def fused_int8_attention_v2(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    r1: float, scale: float, r_out: float, n_valid: int, out_bits: int = 16,
) -> torch.Tensor:
    """q/k/v: (G, N, hd) int8, G = batch·heads, N ≤ 256 unpadded;
    ``n_valid`` = N. ``r1``: ratio from the score scale into the softmax
    input scale ``scale``; ``r_out``: ratio from the context scale into
    the int8 output scale (float32 values). Raises ``ValueError`` where
    ``scale`` fails v2's gate. Returns the int8 (G, N, hd) context,
    through the operator ``ivit::fused_int8_attention_v2``."""
    _check(q, k, v, scale, n_valid, out_bits)
    return _attention_v2_op(q, k, v, float(r1), float(scale), float(r_out), out_bits)


fused_int8_attention_v2.launches = 0
