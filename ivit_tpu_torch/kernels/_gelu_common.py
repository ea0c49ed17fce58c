"""The row-max ShiftGELU chain shared by K4 and K5, plain torch twin.

Counterpart of the duplicated ``_shift_exp`` / ``_kernel`` bodies of
``ivit_tpu/kernels/linear_gelu_fused.py:33-62`` and
``shiftgelu_fused.py:31-55``. The CUDA form is ``csrc/gelu_common.cuh``,
inlined into K4 and K5; the function here states the same arithmetic on
tensors, op for op, so the header can be read against it. It is the
reference-spec form (``ops.shiftgelu`` with ``stable=False``), n = 23,
8-bit output, with every guard kept, followed by the requant to int8.

The scale product ``s_in · 1.702`` and ``−1`` over it are float32, as
in the XLA op. The Pallas kernels form them in float64 at trace time
and agree with this wherever the floors of the two quotients agree.
"""

from __future__ import annotations

import torch

from ..ops import INT8, int_exp_shift, requant
from ..ops.interp import I32_MAX, div, f32

GELU_N = 23  # the shift-exp precision of ShiftGELU


def shiftgelu_rowmax_requant(q: torch.Tensor, s_in: float, r2: float) -> torch.Tensor:
    """Row-max ShiftGELU of ``q`` ((M, C) integer-valued float32 in the
    int8 range, at GELU input scale ``s_in``), requantized by ``r2`` to
    int8 (M, C)."""
    sig_scale = f32(s_in, q.device) * 1.702
    q_max = torch.amax(q, dim=-1, keepdim=True)
    e, _ = int_exp_shift(q - q_max, sig_scale, GELU_N)
    # an all-negative row makes −max > 0 and e_max saturates at 2^31−1
    e_max, _ = int_exp_shift(-q_max, sig_scale, GELU_N)
    s = torch.clamp(e + e_max, 1.0, I32_MAX)
    factor = torch.floor(div(I32_MAX, s))
    sigma = torch.floor(e * factor / 2.0 ** (32 - 8))
    return requant(q * sigma, f32(r2, q.device), *INT8).to(torch.int8)
