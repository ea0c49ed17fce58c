"""K10: fused integer attention over long rows, 256 < N ≤ 1024.

The port's own kernel: the JAX engine has none for these rows. Its
Pallas attention kernels stop at 256 tokens (their two-limb row sum is
exact only up to there), and above it the JAX engine runs the chain as
XLA ops (``ivit_tpu/deploy/engine.py:227-237``), whose Shiftmax sums a
row through three limbs split at 2^12 and the fixed float32 tree
``(s2·2^12 + s1)·2^12 + s0`` (``ops.shiftmax._exact_sum_lastdim``).
K10 runs that chain: int8 Q·Kᵀ → requant → Shiftmax → @V → requant, on
int8 (G, N, hd) q, k, v, the (N, N) scores never in HBM.

The CUDA kernel is ``csrc/attention_long.cu``. It builds on K1's
fragments (``csrc/attention_mma.cuh``), but a warp's 16 rows of 577
requanted scores do not fit in registers, so it stages them in shared
memory and makes three passes over them: the scores and their row max,
the row sum, the probabilities and @V. The shift-exp of z − max z is a
256-entry table, as in K1; a second table holds each entry's three limbs
packed into one 64-bit word, so the row's three limb sums accumulate in
one 64-bit add a score, and the tree then rounds twice in float32 as
the spec's does.

``fused_int8_attention_long_reference`` is the kernel's arithmetic in
plain torch: the table lookup, the limb sums and the tree. It equals
K1's plain version (``fused_int8_attention_reference``, built on
``ops.shiftmax``) bit for bit, which the tests hold it to; the wrapper
runs it for CPU tensors and launches the kernel for CUDA tensors.
"""

from __future__ import annotations

import torch

from ..ops import INT8, requant
from ..ops.interp import I32_MAX, f32
from . import _build
from ._shiftmax_common import norm_factor, shift_exp_table
from .attention_fused import SHIFTMAX_N

MIN_TOKENS = 257
MAX_TOKENS = 1024
MAX_HEAD_DIM = 64


def limb_tree_sum(e: torch.Tensor) -> torch.Tensor:
    """Row sum of shift-exp values ``e`` (integer-valued float32, ≤ 2^31)
    over the last axis, as the kernel forms it: the exact integer sums
    of the limbs e = l2·2^24 + l1·2^12 + l0, then the spec's float32 tree
    ``(s2·2^12 + s1)·2^12 + s0``."""
    u = e.to(torch.int64)
    s2, s1, s0 = ((u >> 24).sum(-1, keepdim=True), ((u >> 12) & 4095).sum(-1, keepdim=True),
                  (u & 4095).sum(-1, keepdim=True))
    s2, s1, s0 = (s.to(torch.float32) for s in (s2, s1, s0))
    return (s2 * 2.0**12 + s1) * 2.0**12 + s0


def fused_int8_attention_long_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    r1: float,
    scale: float,
    r_out: float,
    out_bits: int = 8,
) -> torch.Tensor:
    """Plain torch K10 on (G, N, hd) int8 q, k, v; returns int8 (G, N, hd)."""
    attn = torch.matmul(q.to(torch.float64), k.to(torch.float64).transpose(-1, -2))
    z = requant(attn.to(torch.int32), f32(r1, q.device), *INT8)
    e = shift_exp_table(float(scale), SHIFTMAX_N).to(q.device)[(z.amax(-1, keepdim=True) - z).long()]
    factor = norm_factor(torch.clamp(limb_tree_sum(e), 1.0, I32_MAX), out_bits)
    ctx = torch.matmul(torch.floor(e * factor).to(torch.float64), v.to(torch.float64))
    return requant(ctx.to(torch.int32), f32(r_out, q.device), *INT8).to(torch.int8)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out_bits: int) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.int8 or t.dim() != 3 or not t.is_contiguous():
            raise ValueError(
                f"{name} must be a contiguous (G, N, hd) int8 tensor, got {tuple(t.shape)} {t.dtype}"
            )
        if t.shape != q.shape or t.device != q.device:
            raise ValueError(f"{name} is {tuple(t.shape)} on {t.device}, q {tuple(q.shape)} on {q.device}")
    G, N, hd = q.shape
    if G < 1 or not MIN_TOKENS <= N <= MAX_TOKENS or hd < 4 or hd % 4 or hd > MAX_HEAD_DIM:
        raise ValueError(
            f"q shape {tuple(q.shape)}: need G >= 1, N in [{MIN_TOKENS}, {MAX_TOKENS}] and hd a multiple of 4 "
            f"in [4, {MAX_HEAD_DIM}]"
        )
    if out_bits not in (8, 16):
        raise ValueError(f"out_bits must be 8 or 16, got {out_bits}")


@torch.library.custom_op(
    "ivit::fused_int8_attention_long", mutates_args=(),
    schema="(Tensor q, Tensor k, Tensor v, float r1, float scale, float r_out, int out_bits) -> Tensor",
)
def _attention_long_op(q, k, v, r1, scale, r_out, out_bits):
    if q.device.type == "cpu":
        return fused_int8_attention_long_reference(q, k, v, r1, scale, r_out, out_bits)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if any(t.data_ptr() % 4 for t in (q, k, v)):
        raise ValueError("q, k, v must start on 4-byte boundaries (the kernel loads words)")
    lib = _build.load()
    G, N, hd = q.shape
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = lib.ivit_fused_int8_attention_long(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            G, N, hd, r1, scale, r_out, SHIFTMAX_N, out_bits, stream,
        )
    _build.check(err, "fused_int8_attention_long")
    fused_int8_attention_long.launches += 1
    return out


@_attention_long_op.register_fake
def _(q, k, v, r1, scale, r_out, out_bits):
    return torch.empty_like(q)


def fused_int8_attention_long(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    r1: float,
    scale: float,
    r_out: float,
    out_bits: int = 8,
) -> torch.Tensor:
    """q/k/v: (G, N, hd) int8, G = batch·heads, 257 ≤ N ≤ 1024, hd a
    multiple of 4 up to 64. The ratios are K1's
    (``fused_int8_attention``), float32 values. Returns the int8 (G, N,
    hd) context, through the operator ``ivit::fused_int8_attention_long``."""
    _check(q, k, v, out_bits)
    return _attention_long_op(q, k, v, float(r1), float(scale), float(r_out), out_bits)


fused_int8_attention_long.launches = 0
