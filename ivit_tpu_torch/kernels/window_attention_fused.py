"""K7: fully fused integer Swin window attention.

Replaces ``ivit_tpu/kernels/window_attention_fused.py:fused_int8_window_attention``
(``pl.pallas_call`` at :132). The CUDA kernel is
``csrc/window_attention_fused.cu``, on the int8 tensor-core helpers of K1
(``csrc/attention_mma.cuh``): per batch·window·head cell, int8 Q·Kᵀ on
``mma.sync``, the requant by ``r1``, the relative-position bias merge
``clip(round(a8·rb) + bias)`` (``round(a8·rb)`` from a per-launch table of
the 256 values of a8), the optional shifted-window mask addend
(non-integral f32, added after the clip), the 8-bit Shiftmax with every
guard (K0; the shift-exp from a per-launch table wherever its argument is
an integer in [−255, 0] or at or below the chain's clamp, the chain
itself elsewhere), the exact row sum, @V on ``mma.sync`` with the
probabilities passed in registers, and the requant to int8. A block holds
two 49-token cells at once and takes up to sixteen, in rounds, that share
their bias and mask planes. The (N, N) scores never reach HBM; bytes
bound it on the H100.

The layout is unpadded (G, N, hd) with G = B·nW·heads and the head
innermost: cell i reads bias head ``i % heads`` and mask window
``(i // heads) % nW``, as the Pallas kernel's index maps do. Its 128-lane
padding and ``n_valid`` column mask are TPU tiling, value-identical to
leaving the pads out. N is bounded by 256 (the exact row-sum bound).

``fused_int8_window_attention_reference`` is the plain version: the JAX
XLA engine's chain (``ivit_tpu/deploy/swin_engine.py:465-551``) on the
port's ops, with the integer products in float64 (exact). The wrapper runs
it for CPU tensors and launches the kernel for CUDA tensors.
``window_attention_through_tables`` states the kernel's per-score path
through its tables on tensors, so the CUDA source can be read against it.
"""

from __future__ import annotations

import torch

from ..ops import INT8, requant, shiftmax
from ..ops.interp import f32
from . import _build
from ._shiftmax_common import norm_factor, rb_table, window_shift_exp
from .attention_fused import SHIFTMAX_N
from .attention_fused import _check as _check_qkv


def window_attention_probabilities(
    q: torch.Tensor, k: torch.Tensor, bias: torch.Tensor, mask: torch.Tensor | None,
    r1: float, rb: float, scale: float, heads: int,
) -> torch.Tensor:
    """The 8-bit window attention probabilities (G, N, N), integer-valued
    float32 at scale 1/128: int8 Q·Kᵀ, requant by ``r1``, the bias merge
    at ``rb``, the mask addend, then Shiftmax at the input scale ``scale``."""
    G, N, _ = q.shape
    dev = q.device
    attn = torch.matmul(q.to(torch.float64), k.to(torch.float64).transpose(-1, -2))
    a8 = requant(attn.to(torch.int32), f32(r1, dev), *INT8)
    z = torch.clamp(torch.round(a8 * f32(rb, dev)).view(G // heads, heads, N, N) + bias, *INT8)
    if mask is not None:
        n_windows = mask.shape[0]
        z = z.view(G // (n_windows * heads), n_windows, heads, N, N) + mask[None, :, None]
    sm, _ = shiftmax(z.reshape(G, N, N), f32(scale, dev), out_bits=8, n=SHIFTMAX_N)
    return sm


def fused_int8_window_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
    mask: torch.Tensor | None, r1: float, rb: float, scale: float, r_out: float, heads: int,
) -> torch.Tensor:
    """Plain torch K7 on (G, N, hd) int8 q, k, v; returns int8 (G, N, hd)."""
    sm = window_attention_probabilities(q, k, bias, mask, r1, rb, scale, heads)
    ctx = torch.matmul(sm.to(torch.float64), v.to(torch.float64))
    return requant(ctx.to(torch.int32), f32(r_out, q.device), *INT8).to(torch.int8)


def window_attention_through_tables(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
    mask: torch.Tensor | None, r1: float, rb: float, scale: float, r_out: float, heads: int,
) -> torch.Tensor:
    """K7 as the kernel computes it, on (G, N, hd) int8 q, k, v: the merge
    through ``rb_table`` (indexed by the byte of a8), the shift-exp through
    ``window_shift_exp``, the row sum an exact integer sum rounded once.
    Returns int8 (G, N, hd)."""
    G, N, _ = q.shape
    dev = q.device
    attn = torch.matmul(q.to(torch.float64), k.to(torch.float64).transpose(-1, -2))
    a8 = requant(attn.to(torch.int32), f32(r1, dev), *INT8)
    merged = rb_table(rb).to(dev)[a8.long() & 0xFF]
    z = torch.clamp(merged.view(G // heads, heads, N, N) + bias, *INT8)
    if mask is not None:
        n_windows = mask.shape[0]
        z = z.view(G // (n_windows * heads), n_windows, heads, N, N) + mask[None, :, None]
    z = z.reshape(G, N, N)
    e = window_shift_exp(z - torch.amax(z, dim=-1, keepdim=True), scale, SHIFTMAX_N)
    esum = e.to(torch.int64).sum(-1, keepdim=True).to(torch.float32)
    sm = torch.floor(e * norm_factor(torch.clamp(esum, 1.0, 2.0**31 - 1), 8))
    ctx = torch.matmul(sm.to(torch.float64), v.to(torch.float64))
    return requant(ctx.to(torch.int32), f32(r_out, dev), *INT8).to(torch.int8)


def _check(q, k, v, bias, mask, heads: int) -> None:
    _check_qkv(q, k, v, 8)
    G, N, _ = q.shape
    if heads < 1 or G % heads:
        raise ValueError(f"G={G} cells is not a multiple of heads={heads}")
    planes = [("bias", bias, heads)] + ([] if mask is None else [("mask", mask, mask.shape[0])])
    for name, t, count in planes:
        if t.dtype != torch.float32 or t.shape != (count, N, N) or not t.is_contiguous():
            raise ValueError(
                f"{name} must be a contiguous ({count}, {N}, {N}) float32 tensor, got "
                f"{tuple(t.shape)} {t.dtype}"
            )
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if mask is not None and (mask.shape[0] < 1 or G % (mask.shape[0] * heads)):
        raise ValueError(f"G={G} cells is not a whole number of {mask.shape[0]} windows x {heads} heads")


@torch.library.custom_op(
    "ivit::fused_int8_window_attention", mutates_args=(),
    schema="(Tensor q, Tensor k, Tensor v, Tensor bias, Tensor? mask, float r1, float rb, float scale, "
           "float r_out, int heads) -> Tensor",
)
def _window_attention_op(q, k, v, bias, mask, r1, rb, scale, r_out, heads):
    if q.device.type == "cpu":
        return fused_int8_window_attention_reference(q, k, v, bias, mask, r1, rb, scale, r_out, heads)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if any(t.data_ptr() % 4 for t in (q, k, v)):
        raise ValueError("q, k, v must start on 4-byte boundaries (the kernel loads words)")
    lib = _build.load()
    G, N, hd = q.shape
    n_windows = 1 if mask is None else mask.shape[0]
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = lib.ivit_fused_int8_window_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            None if mask is None else mask.data_ptr(), out.data_ptr(),
            G, N, hd, heads, n_windows, r1, rb, scale, r_out, SHIFTMAX_N, stream,
        )
    _build.check(err, "fused_int8_window_attention")
    fused_int8_window_attention.launches += 1
    return out


@_window_attention_op.register_fake
def _(q, k, v, bias, mask, r1, rb, scale, r_out, heads):
    return torch.empty_like(q)


def fused_int8_window_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: torch.Tensor,
    mask: torch.Tensor | None,
    r1: float,
    rb: float,
    scale: float,
    r_out: float,
    heads: int,
) -> torch.Tensor:
    """q/k/v: (G, N, hd) int8, G = B·nW·heads with the head innermost,
    N ≤ 256 unpadded. ``bias``: (heads, N, N) float32, the frozen integer
    relative-position bias at the softmax input scale; ``mask``: the
    (nW, N, N) float32 shifted-window addend, or None. ``r1``: score →
    ``s_attn1`` ratio; ``rb``: ``s_attn1 → s_bias`` merge ratio;
    ``scale``: the softmax input scale ``s_bias``; ``r_out``: context →
    int8 output ratio (float32 values). Returns the int8 (G, N, hd)
    context, through the operator ``ivit::fused_int8_window_attention``."""
    _check(q, k, v, bias, mask, heads)
    return _window_attention_op(q, k, v, bias, mask, float(r1), float(rb), float(scale), float(r_out), heads)


fused_int8_window_attention.launches = 0
