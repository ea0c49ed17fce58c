"""The row-max ShiftGELU chain shared by K4 and K5, plain torch twin.

Counterpart of the duplicated ``_shift_exp`` / ``_kernel`` bodies of
``ivit_tpu/kernels/linear_gelu_fused.py:33-62`` and
``shiftgelu_fused.py:31-55``. The CUDA form is ``csrc/gelu_common.cuh``,
which fills the table K4 and K5 read; the functions here state the same
arithmetic on tensors, op for op, so the header can be read against
them. It is the reference-spec form (``ops.shiftgelu`` with
``stable=False``), n = 23, 8-bit output, with every guard kept, followed
by the requant to int8.

The scale product ``s_in · 1.702`` and ``−1`` over it are float32, as
in the XLA op. The Pallas kernels form them in float64 at trace time
and agree with this wherever the floors of the two quotients agree.

``gelu_table`` is the twin of the per-(s_in, r2) table that K4 and K5
read (``csrc/linear_gelu_fused.cu:ivit_gelu_table``): the chain's output
depends only on an element and its row's max. ``gelu_table_on`` fills
that table on a card and keeps it.
"""

from __future__ import annotations

import torch

from ..ops import INT8, int_exp_shift, requant
from ..ops.interp import I32_MAX, div, f32
from . import _build

GELU_N = 23  # the shift-exp precision of ShiftGELU
_TABLES: dict = {}  # (s_in, r2, device) -> the card's (256, 256) int8 GELU table


def shiftgelu_given_max(q: torch.Tensor, q_max: torch.Tensor, s_in: float, r2: float) -> torch.Tensor:
    """The chain for elements ``q`` of rows whose max is ``q_max``
    (integer-valued float32 in the int8 range, broadcasting), at GELU
    input scale ``s_in``, requantized by ``r2`` to int8."""
    sig_scale = f32(s_in, q.device) * 1.702
    e, _ = int_exp_shift(q - q_max, sig_scale, GELU_N)
    # an all-negative row makes −max > 0 and e_max saturates at 2^31−1
    e_max, _ = int_exp_shift(-q_max, sig_scale, GELU_N)
    s = torch.clamp(e + e_max, 1.0, I32_MAX)
    factor = torch.floor(div(I32_MAX, s))
    sigma = torch.floor(e * factor / 2.0 ** (32 - 8))
    return requant(q * sigma, f32(r2, q.device), *INT8).to(torch.int8)


def shiftgelu_rowmax_requant(q: torch.Tensor, s_in: float, r2: float) -> torch.Tensor:
    """Row-max ShiftGELU of ``q`` ((M, C) integer-valued float32 in the
    int8 range, at GELU input scale ``s_in``), requantized by ``r2`` to
    int8 (M, C)."""
    return shiftgelu_given_max(q, torch.amax(q, dim=-1, keepdim=True), s_in, r2)


def gelu_table(s_in: float, r2: float) -> torch.Tensor:
    """K4's table: entry ``[i, j]`` is the int8 output of q = int8(j) in a
    row whose max is int8(i) (two's-complement bytes), for q ≤ max; 0
    where q > max (never read). int8 (256, 256) on the CPU."""
    byte = torch.arange(256, dtype=torch.int32)
    value = torch.where(byte < 128, byte, byte - 256).to(torch.float32)
    q, q_max = value[None, :], value[:, None]
    out = shiftgelu_given_max(q, q_max, s_in, r2)
    return torch.where(q <= q_max, out, torch.zeros_like(out))


def gelu_table_on(device: torch.device, s_in: float, r2: float) -> torch.Tensor:
    """The (256, 256) int8 GELU table of (s_in, r2) on a CUDA device,
    filled there by ``ivit_gelu_table`` at first use and kept; raises if
    the fill fails."""
    key = (s_in, r2, device)
    if key not in _TABLES:
        table = torch.empty((256, 256), dtype=torch.int8, device=device)
        with torch.cuda.device(device):
            err = _build.load().ivit_gelu_table(
                table.data_ptr(), s_in, r2, GELU_N, torch.cuda.current_stream(device).cuda_stream
            )
        _build.check(err, "gelu_table")
        _TABLES[key] = table
    return _TABLES[key]
