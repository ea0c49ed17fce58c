"""K0: the shared in-kernel Shiftmax building blocks, plain torch twin.

Counterpart of ``ivit_tpu/kernels/_shiftmax_common.py``. The CUDA form is
``csrc/shiftmax_common.cuh``, inlined into K1, K2, K6 and K7;
the functions here state the same arithmetic on tensors, element for
element, so the header can be read against them. ``exact_rowsum_2limb``
is what the CUDA side computes as an exact 64-bit integer sum rounded
once to float32: both are the correctly rounded exact sum while a row
has at most 256 columns. ``shift_exp_table`` is the per-launch table of
K1 and K2 (``csrc/attention_mma.cuh``); ``rb_table``,
``window_exp_table`` and ``window_shift_exp`` are K7's tables and its
per-score choice between them and the chain
(``csrc/window_attention_fused.cu``).
"""

from __future__ import annotations

import torch

from ..ops.interp import I32_MAX, div, exp2_int

exp2i = exp2_int


def shift_exp_rows(
    z: torch.Tensor, scale: torch.Tensor, n: int, valid: torch.Tensor, clip_e: bool = True
) -> torch.Tensor:
    """The shift-exp chain on row-max-subtracted integer scores ``z``
    (≤ 0); columns where ``valid`` is False come out as exactly 0.
    ``clip_e=False`` elides the per-element clip to [0, 2^31−1], which is
    value-identical only under K2's gate (``p·2^n ≤ 2^31−1``)."""
    z = z + torch.floor(z / 2.0) - torch.floor(z / 16.0)
    x0 = torch.floor(div(-1.0, scale))
    z = torch.maximum(z, n * x0)
    qt = torch.floor(div(z, x0))
    r = z - x0 * qt
    e = torch.floor((r - 2.0 * x0) * exp2i(n - 1.0 - qt))
    if clip_e:
        e = torch.clamp(e, 0.0, I32_MAX)
    return torch.where(valid, e, torch.zeros_like(e))


def shift_exp_table(scale: float, n: int, clip: bool = True) -> torch.Tensor:
    """The shift-exp of every row-max-subtracted score K1 and K2 can
    meet: entry i is ``shift_exp_rows`` at z = −i, i in [0, 255] (their
    scores are int8, so z − max z is an integer in [−255, 0]). ``clip``
    as ``clip_e``: on for K1, off for K2. Float32 (256,) on the CPU."""
    z = 0.0 - torch.arange(256, dtype=torch.float32)
    valid = torch.ones_like(z, dtype=torch.bool)
    return shift_exp_rows(z, torch.tensor(scale, dtype=torch.float32), n, valid, clip)


def rb_table(rb: float) -> torch.Tensor:
    """K7's merge table: entry b is ``round(a8·rb)`` for a8 = int8(b),
    the two's-complement byte the kernel indexes by. Float32 (256,)."""
    byte = torch.arange(256, dtype=torch.int32)
    a8 = torch.where(byte < 128, byte, byte - 256).to(torch.float32)
    return torch.round(a8 * torch.tensor(rb, dtype=torch.float32))


def shift_exp_clamp(scale: float, n: int) -> float:
    """``n·x0``, the clamp of the shift-exp chain: every float32 argument
    at or below it gives the same value (``csrc/window_attention_fused.cu:
    shift_exp_clamps``)."""
    x0 = torch.floor(div(-1.0, torch.tensor(scale, dtype=torch.float32)))
    return float(n * x0)


def window_exp_table(scale: float, n: int) -> torch.Tensor:
    """K7's shift-exp table: K1's 256 entries (the integral arguments
    z − zmax = −i) and a 257th at the clamp. Float32 (257,)."""
    z = torch.cat([0.0 - torch.arange(256, dtype=torch.float32), torch.tensor([shift_exp_clamp(scale, n)])])
    valid = torch.ones_like(z, dtype=torch.bool)
    return shift_exp_rows(z, torch.tensor(scale, dtype=torch.float32), n, valid)


def window_shift_exp(d: torch.Tensor, scale: float, n: int) -> torch.Tensor:
    """K7's shift-exp of row-max-subtracted float32 scores ``d`` (≤ 0), as
    the kernel takes it: the table where ``d`` is an integer in
    [−255, 0], the clamp entry where ``d`` ≤ ``n·x0``, the chain
    elsewhere."""
    table = window_exp_table(scale, n).to(d.device)
    idx = -d
    hit = (idx <= 255) & (torch.round(d) == d)
    chain = shift_exp_rows(d, torch.tensor(scale, dtype=torch.float32, device=d.device), n, torch.ones_like(hit))
    clamped = d <= shift_exp_clamp(scale, n)
    looked = table[torch.where(hit, idx, torch.full_like(idx, 256.0)).long()]
    return torch.where(hit | clamped, looked, chain)


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
