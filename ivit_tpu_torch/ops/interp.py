"""Interpreter parameterization: one integer-op spec, two executions.

Counterpart of ``ivit_tpu/ops/interp.py``. Every integer op is written
once against ``Interp``:

* ``DEPLOY`` — inference: ``torch.floor``, ``torch.round`` (half to
  even, as ``jnp.round``), ``torch.clamp`` and the exact ``exp2_int``;
* ``SIM`` — QAT: the same float32 integer-carrier forward, bit for bit,
  with straight-through gradients: floor and round pass the gradient
  unchanged (``core.ste``), the clip is the exact residue form
  (``core.ste.clip_ste``), and ``exp2`` returns ``exp2_int`` forward
  with the transcendental's gradient ``g·ln2·2^k``.

What else needs care lives here too:

* ``exp2_int`` — exact ``2^k`` built in the float32 exponent field,
  never the approximate transcendental ``exp2``;
* ``div`` and ``f32`` (``core.scalars``) — correctly rounded float32
  division by a device tensor, and the spec's constants as float32
  scalar tensors kept once per CUDA device.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..core.scalars import div, f32
from ..core.ste import clip_ste, floor_ste, round_ste

__all__ = ["DEPLOY", "I32_MAX", "SIM", "Interp", "div", "exp2_int", "f32"]

I32_MAX = 2.0**31 - 1.0  # rounds to 2^31 in float32, as in the JAX spec
_LN2 = 0.6931471805599453


def exp2_int(k: torch.Tensor) -> torch.Tensor:
    """Exact ``2^k`` for integer-valued float32 ``k`` ≥ −126: writes
    ``k + 127`` into the exponent field (int32 arithmetic, wrapping as
    XLA's shift does)."""
    ki = k.to(torch.int32)
    return torch.bitwise_left_shift(ki + 127, 23).view(torch.float32)


class _Exp2Sim(torch.autograd.Function):
    """Forward exactly ``exp2_int``; gradient ``(g·ln2)·2^k`` with 2^k
    from the same exact construction, in the order of
    ``ivit_tpu/ops/interp.py:_exp2_sim_bwd``."""

    @staticmethod
    def forward(k):
        return exp2_int(k)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(output)

    @staticmethod
    def backward(ctx, g):
        (two_k,) = ctx.saved_tensors
        return g * _LN2 * two_k


def _exp2_sim(k: torch.Tensor) -> torch.Tensor:
    return _Exp2Sim.apply(k) if k.requires_grad else exp2_int(k)


@dataclasses.dataclass(frozen=True)
class Interp:
    """Floor, round, clip and exp2 of one interpreter."""

    floor: Callable
    round: Callable
    clip: Callable
    exp2: Callable
    is_sim: bool


SIM = Interp(floor=floor_ste, round=round_ste, clip=clip_ste, exp2=_exp2_sim, is_sim=True)
DEPLOY = Interp(floor=torch.floor, round=torch.round, clip=torch.clamp, exp2=exp2_int, is_sim=False)
