"""K4: int8 fc1 GEMM with the requant → row-max ShiftGELU → requant chain
as its epilogue.

Replaces ``ivit_tpu/kernels/linear_gelu_fused.py:fused_linear_shiftgelu``
(``pl.pallas_call`` at :87). The CUDA kernel is
``csrc/linear_gelu_fused.cu``: a block owns 64 whole rows (32 at small M
or wide C), because the GELU's row max spans all C outputs; the weight
streams through a 3-stage ``cp.async`` ring of shared-memory tiles into
``mma.sync`` s8 products fed by ``ldmatrix``, each output tile is
requantized into an int8 row buffer in shared memory with the row max
folded in, and the GELU chain is one lookup an element in a 256 × 256
table of (q, max q), filled once per (s_in, r2) on the card by
``ivit_gelu_table`` from the unchanged chain of ``csrc/gelu_common.cuh``
and cached by ``_gelu_common.gelu_table_on``, which K5 shares. The
(M, C) int32 accumulator never reaches HBM; the int8 products bound it
at DeiT-S width.

The kernel reads the weight with K contiguous: ``w`` is the (K, C) view
``w_t.T`` of a contiguous (C, K) tensor, which the engine keeps beside
the (K, C) weight (``deploy.artifact``).

``fused_linear_shiftgelu_reference`` is the plain version: the integer
product in float64 (exact below 2^53), the bias, then K5's plain version.
The wrapper runs it for CPU tensors and launches the kernel for CUDA
tensors. ``_gelu_common.gelu_table`` is the table's plain twin.
"""

from __future__ import annotations

import torch

from . import _build
from ._gelu_common import gelu_table_on
from .shiftgelu_fused import fused_requant_shiftgelu_reference

_ROWS = 32  # the fewest rows a block of the kernel takes
_STAGE_BYTES = 3 * 256 * (64 + 16)  # the weight stages of a block
_MAX_SMEM = 227 * 1024


def smem_bytes(K: int, C: int) -> int:
    """Shared memory of a 32-row block: the padded int8 rows of x, the
    weight stages, the int8 GELU inputs and the row maxima
    (``csrc/linear_gelu_fused.cu:plan``)."""
    kp = (K + 31) // 32 * 32
    return _ROWS * (kp + 16) + _STAGE_BYTES + _ROWS * ((C + 127) // 128 * 128 + 16) + 4 * _ROWS


def fused_linear_shiftgelu_reference(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, r1: torch.Tensor, s_in: float, r2: float
) -> torch.Tensor:
    """Plain torch K4: ``x @ w + b`` exact, then K5's chain. Returns int8 (M, C)."""
    acc = torch.matmul(x.to(torch.float64), w.to(torch.float64)).to(torch.int32) + b
    return fused_requant_shiftgelu_reference(acc, r1, s_in, r2)


def _check(x, w, b, r1) -> None:
    if x.dtype != torch.int8 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous (M, K) int8 tensor, got {tuple(x.shape)} {x.dtype}")
    M, K = x.shape
    if w.dtype != torch.int8 or w.dim() != 2 or w.shape[0] != K:
        raise ValueError(f"w must be a ({K}, C) int8 tensor, got {tuple(w.shape)} {w.dtype}")
    C = w.shape[1]
    if w.stride() != (1, K):
        raise ValueError("w must be K-contiguous: pass w_t.T for a contiguous (C, K) w_t")
    if M < 1 or K < 4 or K % 4 or C < 1:
        raise ValueError(f"shapes x {tuple(x.shape)}, w {tuple(w.shape)}: need M, C >= 1 and K a multiple of 4")
    if smem_bytes(K, C) > _MAX_SMEM:
        raise ValueError(f"K={K}, C={C}: a block's rows exceed the 227 KB of shared memory")
    for name, t, dtype in (("b", b, torch.int32), ("r1", r1, torch.float32)):
        if t.dtype != dtype or t.shape != (C,) or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous ({C},) {dtype} tensor, got {tuple(t.shape)} {t.dtype}")
    for name, t in (("w", w), ("b", b), ("r1", r1)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")


@torch.library.custom_op(
    "ivit::fused_linear_shiftgelu", mutates_args=(),
    schema="(Tensor x, Tensor w, Tensor b, Tensor r1, float s_in, float r2) -> Tensor",
)
def _linear_gelu_op(x, w, b, r1, s_in, r2):
    if x.device.type == "cpu":
        return fused_linear_shiftgelu_reference(x, w, b, r1, s_in, r2)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.data_ptr() % 4 or w.data_ptr() % 4:
        raise ValueError("x and w must start on 4-byte boundaries (the kernel loads words)")
    lib = _build.load()
    M, K = x.shape
    C = w.shape[1]
    table = gelu_table_on(x.device, s_in, r2)
    out = torch.empty((M, C), dtype=torch.int8, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.ivit_fused_linear_shiftgelu(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), r1.data_ptr(), table.data_ptr(), out.data_ptr(),
            M, K, C, stream,
        )
    _build.check(err, "fused_linear_shiftgelu")
    fused_linear_shiftgelu.launches += 1
    return out


@_linear_gelu_op.register_fake
def _(x, w, b, r1, s_in, r2):
    return x.new_empty((x.shape[0], w.shape[1]), dtype=torch.int8)


def fused_linear_shiftgelu(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, r1: torch.Tensor, s_in: float, r2: float
) -> torch.Tensor:
    """x: (M, K) int8; w: (K, C) int8, K-contiguous (``w_t.T``); b: (C,)
    int32; r1: (C,) float32 per-channel ratio into the GELU input scale
    ``s_in``; r2: ratio into the output int8 scale. ``s_in`` and ``r2``
    are float32 values. Returns int8 (M, C), through the operator
    ``ivit::fused_linear_shiftgelu``."""
    _check(x, w, b, r1)
    return _linear_gelu_op(x, w, b, r1, float(s_in), float(r2))


fused_linear_shiftgelu.launches = 0
