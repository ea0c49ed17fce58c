"""The device an entry point runs on.

Entry points (the engines, the trainer, freezing) default to the card
and never fall back to the CPU in silence: ``target_device`` raises for
a CUDA device on a machine without one.
"""

from __future__ import annotations

import torch


def target_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises ``RuntimeError`` for a
    CUDA device on a machine without one."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass device='cpu' to run on the CPU")
    return device
