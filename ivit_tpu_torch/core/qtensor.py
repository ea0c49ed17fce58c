"""QTensor: an integer-valued tensor together with its quantization scale.

Counterpart of ``ivit_tpu/core/qtensor.py``. ``q`` holds integers in a
float32 carrier (so straight-through gradients can flow), ``scale`` is a
float32 scalar or a per-channel vector broadcasting against the last
axis, and the represented value is ``q * scale``; ``bits`` is static
metadata. ``int_range`` lives in ``core.quantizers``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class QTensor(NamedTuple):
    q: torch.Tensor
    scale: torch.Tensor
    bits: int = 8

    @property
    def shape(self):
        return self.q.shape

    def dequantize(self) -> torch.Tensor:
        """The real value ``q * scale``."""
        return self.q.to(torch.float32) * self.scale

    def replace(self, **changes) -> "QTensor":
        return self._replace(**changes)

    def reshape(self, *shape) -> "QTensor":
        return self._replace(q=self.q.reshape(*shape))

    def transpose(self, *dims) -> "QTensor":
        return self._replace(q=self.q.permute(*dims))
