"""Batch augmentation: mixup / cutmix with soft targets.

Counterpart of ``ivit_tpu/train/augment.py`` (timm's ``Mixup`` as
``quant_train.py`` configures it: mixup alpha 0.8, cutmix alpha 1.0,
switch prob 0.5, label smoothing folded into the soft targets; the
partner of each sample is the batch reversed).

The four draws (λ_mix, the switch, the box centre, λ_cut) come from a
seeded ``numpy.random.Generator`` on the host (``draw_mixup``): torch's
Beta distribution takes no generator, and JAX's ``jax.random`` streams
cannot be reproduced in torch anyway. Everything after the draws is one
function of the drawn values (``apply_mixup``), on the images' device, in
JAX's float32 arithmetic; the scalars (the box, the realized λ) are
computed on the host in float32, so a step waits on nothing.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.device import target_device

_F = np.float32


class MixupConfig(NamedTuple):
    mixup_alpha: float = 0.8
    cutmix_alpha: float = 1.0
    switch_prob: float = 0.5
    label_smoothing: float = 0.1
    num_classes: int = 1000


class MixupDraws(NamedTuple):
    """The random values of one batch: λ of mixup, whether cutmix is
    used, the box centre (row, column) and λ of cutmix."""

    lam_mix: float
    use_cutmix: bool
    cy: int
    cx: int
    lam_cut: float


def draw_mixup(cfg: MixupConfig, h: int, w: int, generator: np.random.Generator) -> MixupDraws:
    """The draws of one batch of ``h × w`` images from ``generator``."""
    return MixupDraws(
        lam_mix=float(_F(generator.beta(cfg.mixup_alpha, cfg.mixup_alpha))),
        use_cutmix=bool(generator.random() < cfg.switch_prob),
        cy=int(generator.integers(0, h)),
        cx=int(generator.integers(0, w)),
        lam_cut=float(_F(generator.beta(cfg.cutmix_alpha, cfg.cutmix_alpha))),
    )


def one_hot_smooth(labels: torch.Tensor, num_classes: int, smoothing: float) -> torch.Tensor:
    """timm's smoothing: the true class gets 1−ε+ε/n, the others ε/n."""
    off = smoothing / num_classes
    on = 1.0 - smoothing + off
    one_hot = torch.nn.functional.one_hot(labels.long(), num_classes).to(torch.float32)
    return one_hot * float(_F(on - off)) + float(_F(off))


def cutmix_box(h: int, w: int, cy: int, cx: int, lam: float) -> tuple[int, int, int, int]:
    """The cutmix box ``(y0, y1, x0, x1)`` of area ratio about 1 − λ
    centred at (cy, cx), clipped to the image; its sides are
    ``int(h·√(1−λ))`` and ``int(w·√(1−λ))`` in float32, halved by floor."""
    cut = np.sqrt(_F(1.0) - _F(lam))
    ch, cw = int(_F(h) * cut), int(_F(w) * cut)
    return (min(max(cy - ch // 2, 0), h), min(max(cy + ch // 2, 0), h),
            min(max(cx - cw // 2, 0), w), min(max(cx + cw // 2, 0), w))


def apply_mixup(images: torch.Tensor, labels: torch.Tensor, cfg: MixupConfig,
                draws: MixupDraws) -> tuple[torch.Tensor, torch.Tensor]:
    """Mixup or cutmix of NHWC ``images`` with their reversed batch, by
    ``draws``: ``(mixed images, soft targets)`` on the images' device.
    Cutmix pastes the partner inside the box and mixes the targets by the
    realized λ, ``1 − box area / (h·w)``."""
    h, w = images.shape[1], images.shape[2]
    targets = one_hot_smooth(labels.to(images.device), cfg.num_classes, cfg.label_smoothing)
    flipped_img, flipped_tgt = images.flip(0), targets.flip(0)
    if draws.use_cutmix:
        y0, y1, x0, x1 = cutmix_box(h, w, draws.cy, draws.cx, draws.lam_cut)
        out = images.clone()
        out[:, y0:y1, x0:x1] = flipped_img[:, y0:y1, x0:x1]
        lam = _F(1.0) - _F((y1 - y0) * (x1 - x0)) / _F(h * w)
    else:
        lam = _F(draws.lam_mix)
        out = images * float(lam) + flipped_img * float(_F(1.0) - lam)
    return out, targets * float(lam) + flipped_tgt * float(_F(1.0) - lam)


def mixup_cutmix(images: torch.Tensor, labels: torch.Tensor, cfg: MixupConfig,
                 generator: np.random.Generator, device="cuda") -> tuple[torch.Tensor, torch.Tensor]:
    """Mixup or cutmix of a batch of NHWC float ``images`` with integer
    ``labels``, moved to ``device`` (raises for a CUDA device on a machine
    without one): the draws from ``generator`` (``draw_mixup``), then
    ``apply_mixup``. Returns ``(mixed images, soft targets)``."""
    device = target_device(device)
    draws = draw_mixup(cfg, images.shape[1], images.shape[2], generator)
    return apply_mixup(images.to(device), labels.to(device), cfg, draws)
