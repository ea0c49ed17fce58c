"""K3: fused I-LayerNorm → β fold → per-channel requantize to int8.

Replaces ``ivit_tpu/kernels/intnorm_fused.py:fused_layernorm_requant``
(``pl.pallas_call`` at :74). The CUDA kernel is
``csrc/intnorm_fused.cu``: rows in row groups of g lanes (32/g rows a
warp, so the row's scalar Newton chain runs once for them all), exact
int32 group-shuffle sums, the spec's f32 tree op for op, 16-byte loads
where the width and alignment allow, the row and the lane's slices of
β and ratio kept in registers. It is bound by HBM bytes (int16 in, int8
out), so it reads the int16 residual stream directly and never
materializes an f32 carrier. Unlike the Pallas kernel it takes any C,
not only multiples of 128. Its C entry point picks g and the load
width from C and the tensors' alignment.

``fused_layernorm_requant_reference`` is the plain version, built from
``ops.int_layernorm`` and ``ops.requant``; the wrapper runs it for CPU
tensors and launches the kernel for CUDA tensors.
"""

from __future__ import annotations

import torch

from ..ops import INT8, int_layernorm, requant
from . import _build


def fused_layernorm_requant_reference(
    x: torch.Tensor, bias_int: torch.Tensor, ratio: torch.Tensor
) -> torch.Tensor:
    """Plain torch K3: ``int_layernorm`` with γ = 1, β = 0, then the
    folded integer β and the per-channel requant. Returns int8 (M, C)."""
    C = x.shape[-1]
    ones = torch.ones(C, dtype=torch.float32, device=x.device)
    zeros = torch.zeros(C, dtype=torch.float32, device=x.device)
    y, _ = int_layernorm(x, ones, zeros)
    return requant(y + bias_int, ratio, *INT8).to(torch.int8)


def _check(x: torch.Tensor, bias_int: torch.Tensor, ratio: torch.Tensor) -> None:
    if x.dtype != torch.int16 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError(
            f"x must be a contiguous (M, C) int16 tensor, got {tuple(x.shape)} {x.dtype}"
        )
    M, C = x.shape
    if M < 1 or not 1 <= C <= 8192:
        raise ValueError(f"x shape {tuple(x.shape)}: need M >= 1 and 1 <= C <= 8192")
    for name, t in (("bias_int", bias_int), ("ratio", ratio)):
        if t.dtype != torch.float32 or t.shape != (C,) or not t.is_contiguous():
            raise ValueError(
                f"{name} must be a contiguous ({C},) float32 tensor, got {tuple(t.shape)} {t.dtype}"
            )
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")


@torch.library.custom_op(
    "ivit::fused_layernorm_requant", mutates_args=(),
    schema="(Tensor x, Tensor bias_int, Tensor ratio) -> Tensor",
)
def _layernorm_op(x, bias_int, ratio):
    if x.device.type == "cpu":
        return fused_layernorm_requant_reference(x, bias_int, ratio)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    lib = _build.load()
    M, C = x.shape
    out = torch.empty((M, C), dtype=torch.int8, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.ivit_fused_layernorm_requant(
            x.data_ptr(), bias_int.data_ptr(), ratio.data_ptr(), out.data_ptr(), M, C, stream
        )
    _build.check(err, "fused_layernorm_requant")
    fused_layernorm_requant.launches += 1
    return out


@_layernorm_op.register_fake
def _(x, bias_int, ratio):
    return x.new_empty(x.shape, dtype=torch.int8)


def fused_layernorm_requant(
    x: torch.Tensor, bias_int: torch.Tensor, ratio: torch.Tensor
) -> torch.Tensor:
    """x: (M, C) int16; ``bias_int``: (C,) float32 folded β; ``ratio``:
    (C,) float32 per-channel ratio (LN output scale / next input scale).
    Returns int8 (M, C), through the operator
    ``ivit::fused_layernorm_requant``."""
    _check(x, bias_int, ratio)
    return _layernorm_op(x, bias_int, ratio)


fused_layernorm_requant.launches = 0
