"""K0: the shared in-kernel Shiftmax building blocks, plain torch twin.

Counterpart of ``ivit_tpu/kernels/_shiftmax_common.py``. The CUDA form is
``csrc/shiftmax_common.cuh``, inlined into K1 (and later K2, K6, K7);
the functions here state the same arithmetic on tensors, element for
element, so the header can be read against them. ``exact_rowsum_2limb``
is what the CUDA side computes as an exact 64-bit integer sum rounded
once to float32: both are the correctly rounded exact sum while a row
has at most 256 columns.
"""

from __future__ import annotations

import torch

from ..ops.interp import I32_MAX, div, exp2_int

exp2i = exp2_int


def shift_exp_rows(z: torch.Tensor, scale: torch.Tensor, n: int, valid: torch.Tensor) -> torch.Tensor:
    """The shift-exp chain on row-max-subtracted integer scores ``z``
    (≤ 0); columns where ``valid`` is False come out as exactly 0."""
    z = z + torch.floor(z / 2.0) - torch.floor(z / 16.0)
    x0 = torch.floor(div(-1.0, scale))
    z = torch.maximum(z, n * x0)
    qt = torch.floor(div(z, x0))
    r = z - x0 * qt
    e = torch.floor((r - 2.0 * x0) * exp2i(n - 1.0 - qt))
    e = torch.clamp(e, 0.0, I32_MAX)
    return torch.where(valid, e, torch.zeros_like(e))


def exact_rowsum_2limb(e: torch.Tensor) -> torch.Tensor:
    """Row sum of exp values through a base-2^16 hi/lo split; exact for
    rows of at most 256 columns."""
    ehi = torch.floor(e * (1.0 / 2.0**16))
    elo = e - ehi * 2.0**16
    return ehi.sum(-1, keepdim=True) * 2.0**16 + elo.sum(-1, keepdim=True)


def norm_factor(esum: torch.Tensor, out_bits: int) -> torch.Tensor:
    """``⌊(2^31−1)/Σ⌋ · 2^−(32−out_bits)``; ``esum`` already clipped to
    ``[1, 2^31−1]``."""
    return torch.floor(div(I32_MAX, esum)) * (1.0 / 2.0 ** (32 - out_bits))
