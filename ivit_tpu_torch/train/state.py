"""Training state: the model (parameters and ``QuantAct`` ranges), the
optimizer and its state, the step count and the EMA of the parameters.

Counterpart of ``ivit_tpu/train/state.py``, with the two optimizers
``quant_train.py`` builds (``:342-352``), each in optax's order of
operations on lists of tensors:

* ``AdamW`` is ``optax.adamw``: Adam moments, bias correction at the
  incremented count, ``m̂/(√v̂ + eps)``, plus ``weight_decay · p`` on
  every parameter (unmasked), times ``−lr(count)`` with the count before
  its increment;
* ``SGD`` is ``optax.chain(optax.add_decayed_weights(weight_decay),
  optax.sgd(lr, momentum))``: ``g + weight_decay · p``, the trace
  ``g + momentum · trace``, times ``−lr(count)``.

Each optimizer's ``state_dict`` gives its state as flax's
``to_state_dict`` gives the optax state (the layout a JAX checkpoint
holds, keyed by the chain's positions; a learning-rate schedule adds
its step count), and ``load_state_dict`` reads it back.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ..core.device import target_device
from ..nn.flax_state import load_named_tree, named_tree


def _count(count: int) -> np.ndarray:
    return np.asarray(count, np.int32)


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

    def state_dict(self, state: AdamWState, names: list) -> dict:
        """``state`` in optax's layout, the moments keyed by the
        parameters' flax paths (``names``, the torch names in the order
        of ``params``)."""
        schedule = {"count": _count(state.count)} if callable(self.learning_rate) else {}
        adam = {"count": _count(state.count), "mu": named_tree(names, state.mu), "nu": named_tree(names, state.nu)}
        return {"0": adam, "1": {}, "2": schedule}

    def load_state_dict(self, state: AdamWState, names: list, tree: dict) -> None:
        """Read ``tree`` (``state_dict``'s layout) into ``state`` in place."""
        load_named_tree(state.mu, names, tree["0"]["mu"], "AdamW mu")
        load_named_tree(state.nu, names, tree["0"]["nu"], "AdamW nu")
        state.count = int(tree["0"]["count"])


@dataclasses.dataclass
class SGDState:
    count: int
    trace: list


class SGD:
    """``optax.chain(optax.add_decayed_weights(weight_decay),
    optax.sgd(learning_rate, momentum=momentum))``; ``learning_rate`` is a
    number or a function of the step count."""

    def __init__(self, learning_rate: float | Callable[[int], float], momentum: float = 0.9,
                 weight_decay: float = 1e-4):
        self.learning_rate = learning_rate
        self.momentum, self.weight_decay = momentum, weight_decay

    def init(self, params: list) -> SGDState:
        return SGDState(0, [torch.zeros_like(p) for p in params])

    def lr(self, count: int) -> float:
        return self.learning_rate(count) if callable(self.learning_rate) else self.learning_rate

    @torch.no_grad()
    def update(self, params: list, grads: list, state: SGDState) -> None:
        """Apply one update to ``params`` and ``state`` in place."""
        lr = self.lr(state.count)
        # add_decayed_weights: g + wd·p; trace: g + momentum·trace
        decayed = torch._foreach_add(grads, torch._foreach_mul(params, self.weight_decay))
        torch._foreach_mul_(state.trace, self.momentum)
        torch._foreach_add_(state.trace, decayed)
        torch._foreach_add_(params, torch._foreach_mul(state.trace, -lr))
        state.count += 1

    def state_dict(self, state: SGDState, names: list) -> dict:
        """``state`` in optax's layout (see ``AdamW.state_dict``)."""
        schedule = {"count": _count(state.count)} if callable(self.learning_rate) else {}
        return {"0": {}, "1": {"0": {"trace": named_tree(names, state.trace)}, "1": schedule}}

    def load_state_dict(self, state: SGDState, names: list, tree: dict) -> None:
        """Read ``tree`` (``state_dict``'s layout) into ``state`` in place.
        A constant learning rate keeps no count in optax's state, and
        needs none."""
        load_named_tree(state.trace, names, tree["1"]["0"]["trace"], "SGD trace")
        if "count" in tree["1"]["1"]:
            state.count = int(tree["1"]["1"]["count"])


@dataclasses.dataclass
class TrainState:
    """The model holds the live parameters and ``quant_stats`` buffers
    (``models.model_utils.model_variables``); ``ema_params`` (torch name
    → tensor) is None without an EMA. ``zero1`` is the
    ``parallel.data.Zero1`` layout of a state whose moments (and EMA)
    hold only this rank's slices (``parallel.data.shard_train_state``),
    None for a whole state."""

    model: torch.nn.Module
    tx: AdamW | SGD
    opt_state: AdamWState | SGDState
    step: int = 0
    ema_params: dict | None = None
    zero1: object | None = None


def create_train_state(model: torch.nn.Module, tx: AdamW | SGD, ema_decay: float = 0.0, device="cuda") -> TrainState:
    """The train state of ``model`` moved to ``device`` (raises for a
    CUDA device on a machine without one). No range update runs here: a
    fresh ``QuantAct``'s ``min == max == 0`` sentinel makes the first
    real batch assign its range, as JAX's ``create_train_state``
    (``init`` with ``train=False``) leaves it."""
    model = model.to(target_device(device))
    params = list(model.parameters())
    ema = {n: p.detach().clone() for n, p in model.named_parameters()} if ema_decay > 0 else None
    return TrainState(model=model, tx=tx, opt_state=tx.init(params), ema_params=ema)
