"""Loss functions and top-k accuracy.

Counterpart of ``ivit_tpu/train/losses.py``: cross-entropy with label
smoothing (timm's convention), soft-target cross-entropy (the mixup or
smoothed one-hot path), DeiT's distillation wrapper, and top-k accuracy.

The log-softmax and the sums run in float64 and the loss is rounded to
float32 once: float32 would round where its reductions and ``exp``
round, which differ between the CPU and the card, while the float64
value rounds to the same float32 on both.
"""

from __future__ import annotations

import torch


def _log_softmax(logits: torch.Tensor) -> torch.Tensor:
    return torch.log_softmax(logits.to(torch.float64), dim=-1)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, smoothing: float = 0.0) -> torch.Tensor:
    """Mean cross-entropy over integer ``labels``; with ``smoothing`` ε,
    ``(1−ε)·nll + ε·mean(−logp)``."""
    n = logits.shape[-1]
    logp = _log_softmax(logits)
    picked = torch.take_along_dim(logp, labels[:, None].long(), dim=-1)[:, 0]
    if smoothing > 0.0:
        nll = -((1.0 - smoothing) * picked + (smoothing / n) * logp.sum(-1))
    else:
        nll = -picked
    return nll.mean().to(torch.float32)


def soft_target_cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy against soft ``targets`` (rows summing to 1)."""
    logp = _log_softmax(logits)
    return (-targets.to(torch.float64) * logp).sum(-1).mean().to(torch.float32)


def distillation_loss(student_logits, base_loss, teacher_logits=None, kind: str = "none",
                      alpha: float = 0.5, tau: float = 1.0):
    """DeiT distillation: ``"soft"`` (τ²-scaled KL to the teacher's
    softened distribution) or ``"hard"`` (CE to the teacher's argmax),
    mixed with ``base_loss`` by ``alpha``; ``"none"`` or no teacher
    returns ``base_loss``."""
    if kind == "none" or teacher_logits is None:
        return base_loss
    if kind == "soft":
        t = torch.softmax(teacher_logits.to(torch.float64) / tau, dim=-1)
        logp = _log_softmax(student_logits / tau)
        kl = (t * (torch.log(torch.clamp(t, min=1e-12)) - logp)).sum(-1).mean()
        distill = (kl * tau * tau).to(torch.float32)
    elif kind == "hard":
        distill = cross_entropy(student_logits, teacher_logits.argmax(-1))
    else:
        raise ValueError(f"unknown distillation kind {kind!r}")
    return base_loss * (1 - alpha) + distill * alpha


def topk_hits(logits: torch.Tensor, labels: torch.Tensor, k: int = 1) -> torch.Tensor:
    """Per row, 1.0 where ``labels`` is among the ``k`` largest logits
    (ties broken as JAX's stable ascending ``argsort`` breaks them)."""
    topk = torch.argsort(logits, dim=-1, stable=True)[:, -k:]
    return (topk == labels[:, None]).any(-1).to(torch.float32)


def topk_accuracy(logits: torch.Tensor, labels: torch.Tensor, k: int = 1) -> torch.Tensor:
    """Top-k accuracy in [0, 100]."""
    return topk_hits(logits, labels, k).mean() * 100.0
