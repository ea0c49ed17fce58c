"""Training state: the model (parameters and ``QuantAct`` ranges), the
optimizer and its state, the step count and the EMA of the parameters.

Counterpart of ``ivit_tpu/train/state.py``. ``AdamW`` is
``optax.adamw``'s update in optax's order of operations, on lists of
tensors: Adam moments, bias correction at the incremented count,
``m̂/(√v̂ + eps)``, plus ``weight_decay · p`` on every parameter
(unmasked, as ``quant_train.py`` builds it), times ``−lr(count)`` with
the count before its increment.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ..core.device import target_device


@dataclasses.dataclass
class AdamWState:
    count: int
    mu: list
    nu: list


class AdamW:
    """``optax.adamw(learning_rate, b1, b2, eps, weight_decay=...)``;
    ``learning_rate`` is a number or a function of the step count."""

    def __init__(self, learning_rate: float | Callable[[int], float], b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 1e-4):
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps, self.weight_decay = b1, b2, eps, weight_decay

    def init(self, params: list) -> AdamWState:
        return AdamWState(0, [torch.zeros_like(p) for p in params], [torch.zeros_like(p) for p in params])

    def lr(self, count: int) -> float:
        return self.learning_rate(count) if callable(self.learning_rate) else self.learning_rate

    @torch.no_grad()
    def update(self, params: list, grads: list, state: AdamWState) -> None:
        """Apply one update to ``params`` and ``state`` in place."""
        b1, b2 = self.b1, self.b2
        lr = self.lr(state.count)
        count = state.count + 1
        # (1 − b)·g^k + b·moment, each product rounded, as optax's
        # tree_update_moment
        torch._foreach_mul_(state.mu, b1)
        torch._foreach_add_(state.mu, torch._foreach_mul(grads, 1 - b1))
        sq = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(sq, 1 - b2)
        torch._foreach_mul_(state.nu, b2)
        torch._foreach_add_(state.nu, sq)
        # bias corrections 1 − b^count in float32, as optax
        one = np.float32(1.0)
        bc1 = float(one - np.float32(b1) ** np.float32(count))
        bc2 = float(one - np.float32(b2) ** np.float32(count))
        den = torch._foreach_div(state.nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        upd = torch._foreach_div(state.mu, bc1)
        torch._foreach_div_(upd, den)
        if self.weight_decay:
            torch._foreach_add_(upd, torch._foreach_mul(params, self.weight_decay))
        torch._foreach_mul_(upd, -lr)
        torch._foreach_add_(params, upd)
        state.count = count


@dataclasses.dataclass
class TrainState:
    """The model holds the live parameters and ``quant_stats`` buffers
    (``models.model_utils.model_variables``); ``ema_params`` (torch name
    → tensor) is None without an EMA."""

    model: torch.nn.Module
    tx: AdamW
    opt_state: AdamWState
    step: int = 0
    ema_params: dict | None = None


def create_train_state(model: torch.nn.Module, tx: AdamW, ema_decay: float = 0.0, device="cuda") -> TrainState:
    """The train state of ``model`` moved to ``device`` (raises for a
    CUDA device on a machine without one). No range update runs here: a
    fresh ``QuantAct``'s ``min == max == 0`` sentinel makes the first
    real batch assign its range, as JAX's ``create_train_state``
    (``init`` with ``train=False``) leaves it."""
    model = model.to(target_device(device))
    params = list(model.parameters())
    ema = {n: p.detach().clone() for n, p in model.named_parameters()} if ema_decay > 0 else None
    return TrainState(model=model, tx=tx, opt_state=tx.init(params), ema_params=ema)
