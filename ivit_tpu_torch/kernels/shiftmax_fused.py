"""K6: fused requant → masked 16-bit Shiftmax → base-256 (hi, lo) split.

Replaces ``ivit_tpu/kernels/shiftmax_fused.py:fused_requant_shiftmax``
(``pl.pallas_call`` at :95). The CUDA kernel is
``csrc/shiftmax_fused.cu`` on K0 (``csrc/shiftmax_common.cuh``), bound by
HBM bytes (4 B in, 2 B out per score): tiles of 16 rows copied flat into
shared memory by 16-byte ``cp.async`` (4-byte where ``x`` does not start
on a 16-byte boundary), double-buffered, one resident wave of blocks; a
warp a row; the shift-exp of the integral ``z − zmax`` one lookup in a
256-entry table each block fills with the unchanged chain (K1's), the
split in integers, both outputs stored as flat 16-byte spans.
``sm = 256·hi + lo + 128`` feeds the exact @V as two int8 products and a
rank-1 term (the engine's ``"softmax"`` route).

The layout is unpadded (M, N): columns ``j ≥ n_valid`` are masked to
probability 0 (hi = 0, lo = −128), and the Pallas kernel's lane padding
is left out, value-identical. The conversions to int8 saturate, as
XLA's do. N is bounded by 256 (the exact row-sum bound).

``fused_requant_shiftmax_reference`` is the plain version, built from
``ops.requant`` and ``ops.shiftmax``; the wrapper runs it for CPU tensors
and launches the kernel for CUDA tensors.
"""

from __future__ import annotations

import torch

from ..ops import INT8, requant, shiftmax
from ..ops.interp import f32
from . import _build
from .attention_fused import MAX_TOKENS, SHIFTMAX_N


def fused_requant_shiftmax_reference(
    x: torch.Tensor, r1: float, scale: float, n_valid: int, out_bits: int = 16
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch K6 on (M, N) int32 logits; returns int8 (hi, lo), (M, N)."""
    q = requant(x[:, :n_valid], f32(r1, x.device), *INT8)
    sm, _ = shiftmax(q, f32(scale, x.device), out_bits=out_bits, n=SHIFTMAX_N)
    sm = torch.nn.functional.pad(sm, (0, x.shape[1] - n_valid))
    hi = torch.floor(sm / 256.0)
    lo = sm - hi * 256.0 - 128.0
    return (torch.clamp(hi, *INT8).to(torch.int8), torch.clamp(lo, *INT8).to(torch.int8))


def _check(x: torch.Tensor, n_valid: int, out_bits: int) -> None:
    if x.dtype != torch.int32 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous (M, N) int32 tensor, got {tuple(x.shape)} {x.dtype}")
    M, N = x.shape
    if M < 1 or not 1 <= N <= MAX_TOKENS:
        raise ValueError(
            f"x shape {tuple(x.shape)}: need M >= 1 and 1 <= N <= {MAX_TOKENS} "
            "(the exact row-sum bound)"
        )
    if not 1 <= n_valid <= N:
        raise ValueError(f"n_valid must be in [1, {N}], got {n_valid}")
    if out_bits not in (8, 16):
        raise ValueError(f"out_bits must be 8 or 16, got {out_bits}")


@torch.library.custom_op(
    "ivit::fused_requant_shiftmax", mutates_args=(),
    schema="(Tensor x, float r1, float scale, int n_valid, int out_bits) -> (Tensor, Tensor)",
)
def _shiftmax_op(x, r1, scale, n_valid, out_bits):
    if x.device.type == "cpu":
        return fused_requant_shiftmax_reference(x, r1, scale, n_valid, out_bits)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    lib = _build.load()
    M, N = x.shape
    hi = torch.empty((M, N), dtype=torch.int8, device=x.device)
    lo = torch.empty_like(hi)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.ivit_fused_requant_shiftmax(
            x.data_ptr(), hi.data_ptr(), lo.data_ptr(), M, N, n_valid, r1, scale,
            SHIFTMAX_N, out_bits, stream,
        )
    _build.check(err, "fused_requant_shiftmax")
    fused_requant_shiftmax.launches += 1
    return hi, lo


@_shiftmax_op.register_fake
def _(x, r1, scale, n_valid, out_bits):
    hi = x.new_empty(x.shape, dtype=torch.int8)
    return hi, torch.empty_like(hi)


def fused_requant_shiftmax(
    x: torch.Tensor, r1: float, scale: float, n_valid: int, out_bits: int = 16
) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (M, N) int32 attention logits, N ≤ 256 unpadded, the first
    ``n_valid`` columns real. ``r1``: ratio into the Shiftmax input scale
    ``scale`` (float32 values). Returns int8 ``(hi, lo)`` of shape (M, N)
    with ``sm = 256·hi + (lo + 128)`` at scale ``1/2^(out_bits−1)``,
    through the operator ``ivit::fused_requant_shiftmax``."""
    _check(x, n_valid, out_bits)
    return _shiftmax_op(x, float(r1), float(scale), n_valid, out_bits)


fused_requant_shiftmax.launches = 0
