"""K5: fused per-channel requant → row-max ShiftGELU → requant to int8.

Replaces ``ivit_tpu/kernels/shiftgelu_fused.py:fused_requant_shiftgelu``
(``pl.pallas_call`` at :79). The CUDA kernel is
``csrc/shiftgelu_fused.cu``: one warp per row (the row max spans every
channel), the int32 accumulator read from HBM once with 16-byte vector
loads and requantized to int8 q in registers, then the whole GELU chain
as one lookup an element in K4's 256 × 256 table of (max q, q), filled
on the card from the unchanged chain of ``csrc/gelu_common.cuh`` by
``_gelu_common.gelu_table_on``. It is bound by HBM bytes: 4 B in and 1 B
out per element.

``fused_requant_shiftgelu_reference`` is the plain version (``ops.requant``
then the ``_gelu_common`` twin); the wrapper runs it for CPU tensors and
launches the kernel for CUDA tensors.
"""

from __future__ import annotations

import torch

from ..ops import INT8, requant
from . import _build
from ._gelu_common import gelu_table_on, shiftgelu_rowmax_requant


def fused_requant_shiftgelu_reference(
    x: torch.Tensor, r1: torch.Tensor, s_in: float, r2: float
) -> torch.Tensor:
    """Plain torch K5 on the (M, C) int32 accumulator; returns int8 (M, C)."""
    return shiftgelu_rowmax_requant(requant(x, r1, *INT8), s_in, r2)


def _check(x: torch.Tensor, r1: torch.Tensor) -> None:
    if x.dtype != torch.int32 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous (M, C) int32 tensor, got {tuple(x.shape)} {x.dtype}")
    M, C = x.shape
    if M < 1 or C < 4 or C % 4:
        raise ValueError(f"x shape {tuple(x.shape)}: need M >= 1 and C a multiple of 4 (16-byte loads)")
    if r1.dtype != torch.float32 or r1.shape != (C,) or not r1.is_contiguous():
        raise ValueError(f"r1 must be a contiguous ({C},) float32 tensor, got {tuple(r1.shape)} {r1.dtype}")
    if r1.device != x.device:
        raise ValueError(f"r1 is on {r1.device}, x on {x.device}")


@torch.library.custom_op(
    "ivit::fused_requant_shiftgelu", mutates_args=(),
    schema="(Tensor x, Tensor r1, float s_in, float r2) -> Tensor",
)
def _shiftgelu_op(x, r1, s_in, r2):
    if x.device.type == "cpu":
        return fused_requant_shiftgelu_reference(x, r1, s_in, r2)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.data_ptr() % 16 or r1.data_ptr() % 16:
        raise ValueError("x and r1 must start on 16-byte boundaries (the kernel loads 16-byte vectors)")
    lib = _build.load()
    M, C = x.shape
    table = gelu_table_on(x.device, s_in, r2)
    out = torch.empty((M, C), dtype=torch.int8, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.ivit_fused_requant_shiftgelu(
            x.data_ptr(), r1.data_ptr(), table.data_ptr(), out.data_ptr(), M, C, stream
        )
    _build.check(err, "fused_requant_shiftgelu")
    fused_requant_shiftgelu.launches += 1
    return out


@_shiftgelu_op.register_fake
def _(x, r1, s_in, r2):
    return x.new_empty(x.shape, dtype=torch.int8)


def fused_requant_shiftgelu(x: torch.Tensor, r1: torch.Tensor, s_in: float, r2: float) -> torch.Tensor:
    """x: (M, C) int32 fc1 accumulator; ``r1``: (C,) float32 per-channel
    ratio into the int8 GELU input scale ``s_in``; ``r2``: ratio from the
    GELU output scale (``s_in/2^7``) to the fc2 input scale. ``s_in`` and
    ``r2`` are float32 values (a Python float is rounded to float32).
    Returns int8 (M, C), through the operator
    ``ivit::fused_requant_shiftgelu``."""
    _check(x, r1)
    return _shiftgelu_op(x, r1, float(s_in), float(r2))


fused_requant_shiftgelu.launches = 0
