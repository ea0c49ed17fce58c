"""K1: fully fused integer attention.

Replaces ``ivit_tpu/kernels/attention_fused.py:fused_int8_attention``
(``pl.pallas_call`` at :126). The CUDA kernel is
``csrc/attention_fused.cu``, the K1 mode of ``csrc/attention_mma.cuh``.
The (N, N) scores never reach HBM, so HBM traffic is q, k, v in and the
context out, and at DeiT-S batch 128 those bytes bound it on the H100:
both integer products run on the int8 tensor cores (``mma.sync``
m16n8k32; Q·Kᵀ s8×s8, @V u8×s8 with the probabilities passed from one
product to the other in registers), one warp owns 16 query rows against
every key of its batch·head, and the shift-exp chain (K0,
``csrc/shiftmax_common.cuh``), which depends only on the integer
z − max z ∈ [−255, 0], is a 256-entry table each block fills once
(``_shiftmax_common.shift_exp_table`` is its plain twin). Per score
what remains is the requant, the max, one lookup, a multiply and a
floor.

The probabilities reach 2^(out_bits−1): 128 at 8 bits and 32768 at 16,
in a one-token row whose ``1/scale`` is a power of two. So the @V
operand is unsigned, 16-bit probabilities go in as two u8 halves
(256·hi + lo), and nothing saturates. The Pallas kernel's signed split
``hi.astype(int8)`` saturates hi = 128 to 127 there; the port follows
the JAX engine's XLA composition, which does not.

The layout is unpadded (G, N, hd): the Pallas kernel's 128-lane padding
and pad-column mask are TPU tiling, value-identical to leaving the pads
out. N is bounded by 256, as in the JAX kernel (the exact row-sum bound);
longer rows raise.

``fused_int8_attention_reference`` is the plain version, built from
``ops.requant`` and ``ops.shiftmax``; the integer products run in float64,
exact below 2^53, since CUDA has no integer matmul. The wrapper runs it
for CPU tensors and launches the kernel for CUDA tensors.
"""

from __future__ import annotations

import torch

from ..ops import INT8, requant, shiftmax
from ..ops.interp import f32
from . import _build

MAX_TOKENS = 256
SHIFTMAX_N = 15  # the shift-exp precision of the attention Shiftmax


def attention_probabilities(
    q: torch.Tensor, k: torch.Tensor, r1: float, scale: float, out_bits: int = 8
) -> torch.Tensor:
    """Integer attention probabilities (G, N, N), integer-valued float32
    at scale ``1/2^(out_bits−1)``: int8 Q·Kᵀ, requant by ``r1`` into the
    softmax input scale ``scale``, then Shiftmax."""
    attn = torch.matmul(q.to(torch.float64), k.to(torch.float64).transpose(-1, -2))
    a8 = requant(attn.to(torch.int32), f32(r1, q.device), *INT8)
    sm, _ = shiftmax(a8, f32(scale, q.device), out_bits=out_bits, n=SHIFTMAX_N)
    return sm


def fused_int8_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    r1: float,
    scale: float,
    r_out: float,
    out_bits: int = 8,
) -> torch.Tensor:
    """Plain torch K1 on (G, N, hd) int8 q, k, v; returns int8 (G, N, hd)."""
    sm = attention_probabilities(q, k, r1, scale, out_bits)
    ctx = torch.matmul(sm.to(torch.float64), v.to(torch.float64))
    return requant(ctx.to(torch.int32), f32(r_out, q.device), *INT8).to(torch.int8)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out_bits: int) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.int8 or t.dim() != 3 or not t.is_contiguous():
            raise ValueError(
                f"{name} must be a contiguous (G, N, hd) int8 tensor, got "
                f"{tuple(t.shape)} {t.dtype}"
            )
        if t.shape != q.shape or t.device != q.device:
            raise ValueError(f"{name} is {tuple(t.shape)} on {t.device}, q {tuple(q.shape)} on {q.device}")
    G, N, hd = q.shape
    if G < 1 or N < 1 or hd < 4 or hd % 4 or hd > 256:
        raise ValueError(f"q shape {tuple(q.shape)}: need G, N >= 1 and hd a multiple of 4 in [4, 256]")
    if N > MAX_TOKENS:
        raise ValueError(
            f"fused attention supports <= {MAX_TOKENS} tokens (got {N}): the exact "
            "row-sum bound of the kernel"
        )
    if out_bits not in (8, 16):
        raise ValueError(f"out_bits must be 8 or 16, got {out_bits}")


@torch.library.custom_op(
    "ivit::fused_int8_attention", mutates_args=(),
    schema="(Tensor q, Tensor k, Tensor v, float r1, float scale, float r_out, int out_bits) -> Tensor",
)
def _attention_op(q, k, v, r1, scale, r_out, out_bits):
    if q.device.type == "cpu":
        return fused_int8_attention_reference(q, k, v, r1, scale, r_out, out_bits)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if any(t.data_ptr() % 4 for t in (q, k, v)):
        raise ValueError("q, k, v must start on 4-byte boundaries (the kernel loads words)")
    lib = _build.load()
    G, N, hd = q.shape
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = lib.ivit_fused_int8_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            G, N, hd, r1, scale, r_out, SHIFTMAX_N, out_bits, stream,
        )
    _build.check(err, "fused_int8_attention")
    fused_int8_attention.launches += 1
    return out


@_attention_op.register_fake
def _(q, k, v, r1, scale, r_out, out_bits):
    return torch.empty_like(q)


def fused_int8_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    r1: float,
    scale: float,
    r_out: float,
    out_bits: int = 8,
) -> torch.Tensor:
    """q/k/v: (G, N, hd) int8, G = batch·heads, N ≤ 256 unpadded.
    ``r1``: ratio from the score scale into the softmax input scale
    ``scale``; ``r_out``: ratio from the context scale
    (softmax scale · v scale) into the int8 output scale. The three are
    float32 values (a Python float is rounded to float32). Returns the
    int8 (G, N, hd) context, through the operator
    ``ivit::fused_int8_attention``."""
    _check(q, k, v, out_bits)
    return _attention_op(q, k, v, float(r1), float(scale), float(r_out), out_bits)


fused_int8_attention.launches = 0
