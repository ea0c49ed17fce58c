"""Learning-rate schedule.

Counterpart of ``ivit_tpu/train/schedule.py``: linear warmup, then cosine
decay to ``min_lr`` (default lr/15) — optax's
``warmup_cosine_decay_schedule``, evaluated in float32 in optax's order
of operations (its warmup's ``(init − peak)·frac + peak`` cancels in
float32, and the rate follows it).
"""

from __future__ import annotations

import math

import numpy as np

_F = np.float32


def cosine_schedule(
    base_lr: float,
    steps_per_epoch: int,
    epochs: int,
    warmup_epochs: int = 5,
    warmup_lr: float = 1e-6,
    min_lr: float | None = None,
):
    """A function from the step count (0 for the first update, as optax
    counts) to the learning rate, a float holding a float32 value."""
    if min_lr is None:
        min_lr = base_lr / 15.0
    init = min(warmup_lr, base_lr)
    warmup_steps = max(1, warmup_epochs * steps_per_epoch)
    decay_steps = max(warmup_steps + 1, epochs * steps_per_epoch) - warmup_steps
    alpha = 0.0 if base_lr == 0.0 else min_lr / base_lr

    def schedule(count: int) -> float:
        if count < warmup_steps:  # optax.linear_schedule
            frac = _F(1) - _F(max(count, 0)) / _F(warmup_steps)
            return float(_F(init - base_lr) * frac + _F(base_lr))
        t = _F(min(count - warmup_steps, decay_steps))  # optax.cosine_decay_schedule
        cosine = _F(0.5) * (_F(1) + np.cos(_F(math.pi) * t / _F(decay_steps)))
        return float(_F(base_lr) * (_F(1 - alpha) * cosine + _F(alpha)))

    return schedule
