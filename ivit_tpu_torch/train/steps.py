"""Train and eval steps.

Counterpart of ``ivit_tpu/train/steps.py``. ``train=True`` runs the
model with its ``QuantAct`` ranges moving (the reference's
``unfreeze_model``); evaluation runs frozen ranges.
"""

from __future__ import annotations

import torch

from ..ops.interp import div
from .losses import soft_target_cross_entropy, topk_accuracy, topk_hits
from .state import TrainState


def make_train_step(model: torch.nn.Module, ema_decay: float = 0.0, grad_clip: float | None = None):
    """A train step ``(state, images, soft_targets, generator) → (state,
    metrics)`` for ``state.model is model``: one forward with
    ``train=True`` (the ranges move), the soft-target loss (targets are
    mixup or smoothed one-hot rows the caller prepares), the gradients,
    the global-norm clip ``min(1, clip/(‖g‖ + 1e-6))`` when
    ``grad_clip`` is set, the optimizer's update, then the EMA of the
    parameters. The state is updated in place and returned; the metrics
    stay tensors on the device (reading them waits for the step)."""

    def train_step(state: TrainState, images: torch.Tensor, targets: torch.Tensor,
                   generator: torch.Generator | None = None):
        names, params = zip(*model.named_parameters())
        logits = model(images, train=True, generator=generator)
        loss = soft_target_cross_entropy(logits, targets)
        grads = list(torch.autograd.grad(loss, params, materialize_grads=True))  # β gets none
        with torch.no_grad():
            if grad_clip is not None:
                norms = torch.stack(torch._foreach_norm(grads))
                gnorm = torch.sqrt((norms * norms).sum())
                torch._foreach_mul_(grads, torch.clamp(div(grad_clip, gnorm + 1e-6), max=1.0))
            state.tx.update(list(params), grads, state.opt_state)
            if state.ema_params is not None:
                ema = [state.ema_params[n] for n in names]
                torch._foreach_mul_(ema, ema_decay)
                torch._foreach_add_(ema, torch._foreach_mul(list(params), 1.0 - ema_decay))
            state.step += 1
            metrics = {"loss": loss.detach(), "acc1": topk_accuracy(logits.detach(), targets.argmax(-1), 1)}
        return state, metrics

    return train_step


def make_eval_step(model: torch.nn.Module, return_logits: bool = False):
    """A frozen-range eval step ``(variables, images, labels, n_valid) →
    metrics`` (and the logits with ``return_logits``): ``model`` runs on
    ``variables`` (``models.model_utils.eval_variables``) with
    ``train=False``; rows at or past ``n_valid`` (padding up to a batch
    multiple) count in no accuracy."""

    @torch.no_grad()
    def eval_step(variables: dict, images: torch.Tensor, labels: torch.Tensor, n_valid: int):
        logits = torch.func.functional_call(
            model, {**variables["params"], **variables["quant_stats"]}, (images,), {"train": False})
        valid = (torch.arange(labels.shape[0], device=labels.device) < n_valid).to(torch.float32)
        metrics = {f"acc{k}": (topk_hits(logits, labels, k) * valid).sum() / n_valid * 100.0 for k in (1, 5)}
        return (metrics, logits) if return_logits else metrics

    return eval_step
