"""DEPLOY interpreter primitives on torch tensors.

Counterpart of the DEPLOY half of ``ivit_tpu/ops/interp.py``. The ops
use ``torch.floor``, ``torch.round`` (half to even, as ``jnp.round``)
and ``torch.clamp`` directly; what needs care lives here:

* ``exp2_int`` — exact ``2^k`` built in the float32 exponent field,
  never the approximate transcendental ``exp2``;
* ``div`` — a float32 true division whose divisor is a tensor on the
  numerator's device. PyTorch's CUDA ``div`` turns a Python-scalar
  divisor into a reciprocal multiply, which rounds differently from the
  correctly rounded division the spec takes the floor of;
* ``f32`` — the float32 scalar tensors the spec's constants become. On a
  CUDA device each is made once per (value, device) and kept: building
  one from a Python number copies it from pageable host memory, which
  synchronises the stream and cannot be recorded in a CUDA graph, so a
  forward makes no such copy after its first call.

The QAT interpreter (straight-through floor/round) comes with the QAT
port.
"""

from __future__ import annotations

import numpy as np
import torch

I32_MAX = 2.0**31 - 1.0  # rounds to 2^31 in float32, as in the JAX spec


def exp2_int(k: torch.Tensor) -> torch.Tensor:
    """Exact ``2^k`` for integer-valued float32 ``k`` ≥ −126: writes
    ``k + 127`` into the exponent field (int32 arithmetic, wrapping as
    XLA's shift does)."""
    ki = k.to(torch.int32)
    return torch.bitwise_left_shift(ki + 127, 23).view(torch.float32)


_CONSTANTS: dict = {}  # (float32 bits, CUDA device) -> the scalar tensor there


def div(num, den) -> torch.Tensor:
    """Correctly rounded float32 ``num / den``; either side may be a
    Python number, which becomes ``f32`` on the other's device."""
    like = den if isinstance(den, torch.Tensor) else num
    if not isinstance(num, torch.Tensor):
        num = f32(num, like.device)
    if not isinstance(den, torch.Tensor):
        den = f32(den, like.device)
    return torch.div(num, den)


def f32(value: float, device) -> torch.Tensor:
    """A float32 scalar tensor on ``device`` (a Python float is rounded
    to float32, as a kernel's float argument is). On a CUDA device the
    tensor is made at the first call for its value and shared after:
    callers must not write to it."""
    device = torch.device(device)
    if device.type != "cuda":
        return torch.tensor(value, dtype=torch.float32, device=device)
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    key = (int(np.float32(value).view(np.uint32)), device)
    if key not in _CONSTANTS:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"f32({value}) first made during CUDA graph capture: warm up before capturing")
        with torch.inference_mode(False):
            _CONSTANTS[key] = torch.tensor(value, dtype=torch.float32, device=device)
    return _CONSTANTS[key]
