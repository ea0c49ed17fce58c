"""Float32 scalars on a device, and the division that uses them.

* ``div`` — a float32 true division whose divisor is a tensor on the
  numerator's device. PyTorch's CUDA ``div`` turns a Python-scalar
  divisor into a reciprocal multiply, which rounds differently from the
  correctly rounded division the spec takes the floor of;
* ``f32`` — the float32 scalar tensors the spec's constants become. On a
  CUDA device each is made once per (value, device) and kept: building
  one from a Python number copies it from pageable host memory, which
  synchronises the stream and cannot be recorded in a CUDA graph, so a
  forward makes no such copy after its first call.

They live in ``core`` so that the scale computation
(``core.quantizers``) can use them below ``ops``, which imports ``core``.
"""

from __future__ import annotations

import numpy as np
import torch

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
