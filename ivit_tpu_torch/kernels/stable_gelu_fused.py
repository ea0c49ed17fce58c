"""K9: fc1's bias add → per-channel requant → stable ShiftGELU → requant
to int8, as one table lookup an element.

The port's own kernel: the JAX engine runs this epilogue of the fc1 GEMM
as XLA ops (``ivit_tpu/deploy/engine.py``'s MLP under ``gelu_stable``),
and so does the port's plain path (``deploy.engine._mlp_hidden`` with
``kernels=()``). The stable ShiftGELU (``ops.shiftgelu(stable=True)``)
reads the element alone, never its row, so everything after the fc1
requant depends only on q ∈ [−128, 127] and on the block's GELU input
scale and output ratio: a 256-entry int8 table a block,
``stable_gelu_table``, filled by the plain chain itself on the engine's
device. The CUDA kernel is ``csrc/stable_gelu_fused.cu``; it is bound by
HBM bytes: 4 B in and 1 B out an element.

``fused_requant_stable_gelu_reference`` is the plain version (the int32
bias add, ``ops.requant``, the lookup); the wrapper runs it for CPU
tensors and launches the kernel for CUDA tensors.
"""

from __future__ import annotations

import torch

from ..ops import INT8, requant, shiftgelu
from . import _build


def stable_gelu_table(scale: torch.Tensor, ratio: torch.Tensor) -> torch.Tensor:
    """The (256,) int8 table of a block whose GELU input scale is
    ``scale`` and whose output ratio is ``ratio`` (float32 scalars on the
    engine's device): entry i is the plain chain's output for q = i − 128,
    ``requant(shiftgelu(q, scale, stable=True), ratio)`` as int8, computed
    by those functions on ``scale``'s device. Call it outside any CUDA
    graph capture."""
    q = torch.arange(-128, 128, dtype=torch.float32, device=scale.device)
    g, _ = shiftgelu(q, scale, out_bits=8, stable=True)
    return requant(g, ratio, *INT8).to(torch.int8)


def fused_requant_stable_gelu_reference(
    x: torch.Tensor, b: torch.Tensor, r1: torch.Tensor, table: torch.Tensor
) -> torch.Tensor:
    """Plain torch K9 on the (M, C) int32 fc1 accumulator; returns int8 (M, C)."""
    return table[requant(x + b, r1, *INT8).to(torch.int64) + 128]


def _check(x: torch.Tensor, b: torch.Tensor, r1: torch.Tensor, table: torch.Tensor) -> None:
    if x.dtype != torch.int32 or x.dim() != 2 or not x.is_contiguous() or x.numel() == 0:
        raise ValueError(f"x must be a non-empty contiguous (M, C) int32 tensor, got {tuple(x.shape)} {x.dtype}")
    C = x.shape[1]
    for name, t, dtype, shape in (("b", b, torch.int32, (C,)), ("r1", r1, torch.float32, (C,)),
                                  ("table", table, torch.int8, (256,))):
        if t.dtype != dtype or t.shape != shape or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {shape} {dtype} tensor, got {tuple(t.shape)} {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")


@torch.library.custom_op(
    "ivit::fused_requant_stable_gelu", mutates_args=(),
    schema="(Tensor x, Tensor b, Tensor r1, Tensor table) -> Tensor",
)
def _stable_gelu_op(x, b, r1, table):
    if x.device.type == "cpu":
        return fused_requant_stable_gelu_reference(x, b, r1, table)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    lib = _build.load()
    M, C = x.shape
    out = torch.empty((M, C), dtype=torch.int8, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.ivit_fused_requant_stable_gelu(
            x.data_ptr(), b.data_ptr(), r1.data_ptr(), table.data_ptr(), out.data_ptr(), M, C, stream
        )
    _build.check(err, "fused_requant_stable_gelu")
    fused_requant_stable_gelu.launches += 1
    return out


@_stable_gelu_op.register_fake
def _(x, b, r1, table):
    return x.new_empty(x.shape, dtype=torch.int8)


def fused_requant_stable_gelu(
    x: torch.Tensor, b: torch.Tensor, r1: torch.Tensor, table: torch.Tensor
) -> torch.Tensor:
    """x: (M, C) int32 fc1 accumulator; ``b``: (C,) int32 bias added to it
    first (an int32 add, which wraps as the plain path's); ``r1``: (C,) float32
    per-channel ratio into the int8 GELU input scale; ``table``: the
    block's (256,) int8 ``stable_gelu_table``. Returns int8 (M, C),
    through the operator ``ivit::fused_requant_stable_gelu``."""
    _check(x, b, r1, table)
    return _stable_gelu_op(x, b, r1, table)


fused_requant_stable_gelu.launches = 0
