"""Train and eval steps.

Counterpart of ``ivit_tpu/train/steps.py``. ``train=True`` runs the
model with its ``QuantAct`` ranges moving (the reference's
``unfreeze_model``); evaluation runs frozen ranges.
"""

from __future__ import annotations

import torch

from ..nn.quant import data_shard
from ..parallel.data import batch_shard, data_mean, zero1_update
from ..ops.interp import div
from ..utils.spans import Span
from .losses import soft_target_cross_entropy, topk_accuracy, topk_hits
from .state import TrainState

# the phases of a train step (utils/spans.py)
FORWARD, BACKWARD, OPTIMIZER = (Span(f"train.{phase}") for phase in ("forward", "backward", "optimizer"))


def make_train_step(model: torch.nn.Module, ema_decay: float = 0.0, grad_clip: float | None = None,
                    mesh=None):
    """A train step ``(state, images, soft_targets, generator) → (state,
    metrics)`` for ``state.model is model``: one forward with
    ``train=True`` (the ranges move), the soft-target loss (targets are
    mixup or smoothed one-hot rows the caller prepares), the gradients,
    the global-norm clip ``min(1, clip/(‖g‖ + 1e-6))`` when
    ``grad_clip`` is set, the optimizer's update, then the EMA of the
    parameters. The state is updated in place and returned; the metrics
    stay tensors on the device (reading them waits for the step).

    With a ``mesh`` (``parallel.make_mesh``) the step is data-parallel
    (``parallel.data``): every rank passes the same global batch and the
    same generator state, runs its rows with global ranges and masks,
    and averages the gradients and the metrics over the ``data`` axis; a
    state sliced by ``parallel.data.shard_train_state`` takes the ZeRO-1
    update. A tensor-parallel model (``parallel.tensor_parallel``, on
    the mesh's ``model`` axis) also sums over the model group the
    gradients each rank forms in part, and clips by the norm of the
    whole model.

    The step runs in the spans ``train.forward`` (the forward and the
    loss), ``train.backward`` (the gradients) and ``train.optimizer``
    (the reductions, the clip, the update, the EMA and the metrics)."""
    shard = None if mesh is None else batch_shard(mesh)
    tp = getattr(model, "tp", None)
    if tp is not None and mesh is None:
        raise ValueError("a tensor-parallel model trains with its mesh: make_train_step(model, ..., mesh=mesh)")

    def train_step(state: TrainState, images: torch.Tensor, targets: torch.Tensor,
                   generator: torch.Generator | None = None):
        names, params = zip(*model.named_parameters())
        with FORWARD:
            if mesh is not None:
                images, targets = mesh.block(images, "data"), mesh.block(targets, "data")
            with data_shard(shard):
                logits = model(images, train=True, generator=generator)
            loss = soft_target_cross_entropy(logits, targets)
        with BACKWARD:
            grads = list(torch.autograd.grad(loss, params, materialize_grads=True))  # β gets none
        with OPTIMIZER, torch.no_grad():
            if mesh is not None:
                grads = data_mean(grads, mesh)
            if tp is not None:
                grads = tp.reduce_grads(grads, names)
            if grad_clip is not None:
                if tp is None:
                    norms = torch.stack(torch._foreach_norm(grads))
                    gnorm = torch.sqrt((norms * norms).sum())
                else:
                    gnorm = tp.global_norm(grads, names)
                torch._foreach_mul_(grads, torch.clamp(div(grad_clip, gnorm + 1e-6), max=1.0))
            if state.zero1 is not None:
                zero1_update(state, list(params), grads, ema_decay)
            else:
                state.tx.update(list(params), grads, state.opt_state)
                if state.ema_params is not None:
                    ema = [state.ema_params[n] for n in names]
                    torch._foreach_mul_(ema, ema_decay)
                    torch._foreach_add_(ema, torch._foreach_mul(list(params), 1.0 - ema_decay))
            state.step += 1
            metrics = {"loss": loss.detach(), "acc1": topk_accuracy(logits.detach(), targets.argmax(-1), 1)}
            if mesh is not None:
                metrics = dict(zip(metrics, data_mean(list(metrics.values()), mesh)))
        return state, metrics

    return train_step


def make_eval_step(model: torch.nn.Module, return_logits: bool = False, mesh=None):
    """A frozen-range eval step ``(variables, images, labels, n_valid) →
    metrics`` (and the logits with ``return_logits``): ``model`` runs on
    ``variables`` (``models.model_utils.eval_variables``) with
    ``train=False``; rows at or past ``n_valid`` (padding up to a batch
    multiple) count in no accuracy. With a ``mesh`` every rank passes the
    same global batch (a multiple of the ``data`` axis), runs its rows
    (a tensor-parallel model its share of them), and the hits are summed
    and the logits gathered over ``data``."""

    @torch.no_grad()
    def eval_step(variables: dict, images: torch.Tensor, labels: torch.Tensor, n_valid: int):
        rows = torch.arange(labels.shape[0], device=labels.device)
        if mesh is not None:
            images, labels, rows = (mesh.block(t, "data") for t in (images, labels, rows))
        with data_shard(None if mesh is None else batch_shard(mesh)):
            logits = torch.func.functional_call(
                model, {**variables["params"], **variables["quant_stats"]}, (images,), {"train": False})
        valid = (rows < n_valid).to(torch.float32)
        hits = torch.stack([(topk_hits(logits, labels, k) * valid).sum() for k in (1, 5)])
        if mesh is not None:
            hits, logits = mesh.all_reduce(hits, "data"), mesh.all_gather(logits, "data")
        metrics = {f"acc{k}": h / n_valid * 100.0 for k, h in zip((1, 5), hits)}
        return (metrics, logits) if return_logits else metrics

    return eval_step
