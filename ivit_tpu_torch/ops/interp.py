"""DEPLOY interpreter primitives on torch tensors.

Counterpart of the DEPLOY half of ``ivit_tpu/ops/interp.py``. The ops
use ``torch.floor``, ``torch.round`` (half to even, as ``jnp.round``)
and ``torch.clamp`` directly; what needs care lives here:

* ``exp2_int`` — exact ``2^k`` built in the float32 exponent field,
  never the approximate transcendental ``exp2``;
* ``div`` — a float32 true division whose divisor is a tensor on the
  numerator's device. PyTorch's CUDA ``div`` turns a Python-scalar
  divisor into a reciprocal multiply, which rounds differently from the
  correctly rounded division the spec takes the floor of.

The QAT interpreter (straight-through floor/round) comes with the QAT
port.
"""

from __future__ import annotations

import torch

I32_MAX = 2.0**31 - 1.0  # rounds to 2^31 in float32, as in the JAX spec


def exp2_int(k: torch.Tensor) -> torch.Tensor:
    """Exact ``2^k`` for integer-valued float32 ``k`` ≥ −126: writes
    ``k + 127`` into the exponent field (int32 arithmetic, wrapping as
    XLA's shift does)."""
    ki = k.to(torch.int32)
    return torch.bitwise_left_shift(ki + 127, 23).view(torch.float32)


def div(num, den) -> torch.Tensor:
    """Correctly rounded float32 ``num / den``; either side may be a
    Python number, which becomes a float32 tensor on the other's device."""
    like = den if isinstance(den, torch.Tensor) else num
    if not isinstance(num, torch.Tensor):
        num = torch.tensor(num, dtype=torch.float32, device=like.device)
    if not isinstance(den, torch.Tensor):
        den = torch.tensor(den, dtype=torch.float32, device=like.device)
    return torch.div(num, den)
