"""K1: fully fused integer attention.

Replaces ``ivit_tpu/kernels/attention_fused.py:fused_int8_attention``
(``pl.pallas_call`` at :126). The CUDA kernel is
``csrc/attention_fused.cu``: per batch·head it stages K and V in shared
memory (25 KB at DeiT-S), one warp per query row computes the int8 Q·Kᵀ
with ``__dp4a``, requantizes, runs the whole Shiftmax chain (K0,
``csrc/shiftmax_common.cuh``) on scores held in registers, and sums the
probabilities against V exactly in int32 before the final requant. The
(N, N) scores never reach HBM, so HBM traffic is q, k, v in and the
context out. What bounds it on the H100 is on-chip work: per row 2·N·hd
integer MACs on the CUDA cores, and in the @V loop two shared-memory
loads per MAC (one probability, one V byte). Int8 tensor-core MMA for
both products is later work.

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
from . import _build

MAX_TOKENS = 256
SHIFTMAX_N = 15  # the shift-exp precision of the attention Shiftmax


def _f32(value: float, device) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.float32, device=device)


def attention_probabilities(
    q: torch.Tensor, k: torch.Tensor, r1: float, scale: float, out_bits: int = 8
) -> torch.Tensor:
    """Integer attention probabilities (G, N, N), integer-valued float32
    at scale ``1/2^(out_bits−1)``: int8 Q·Kᵀ, requant by ``r1`` into the
    softmax input scale ``scale``, then Shiftmax."""
    attn = torch.matmul(q.to(torch.float64), k.to(torch.float64).transpose(-1, -2))
    a8 = requant(attn.to(torch.int32), _f32(r1, q.device), *INT8)
    sm, _ = shiftmax(a8, _f32(scale, q.device), out_bits=out_bits, n=SHIFTMAX_N)
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
    return requant(ctx.to(torch.int32), _f32(r_out, q.device), *INT8).to(torch.int8)


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
    int8 (G, N, hd) context."""
    _check(q, k, v, out_bits)
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


fused_int8_attention.launches = 0
