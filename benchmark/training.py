"""What the training loop shares with the control: the job's inputs made
from the seed, the program's train step built on them, the reference's
first steps, and the comparison of the two.

The benchmark draws the float weights, a pool of batches (images and
labels) on the device, and for step i the draws ``quant_train`` makes
for it (a numpy generator for mixup/cutmix seeded ``(seed, 0, i, 0)`` and
a torch generator on the device for drop-path, seeded from
``(seed, 0, i, 1)``); the program and the reference get the same ones.
The comparison takes each checked step's loss, the first gradient as
the optimizer holds it after step 1 (AdamW's first moment over 1 − β1)
and the parameters' change over the checked steps, the last two by the
worst leaf: the gap between the program's norm and the reference's, over
the larger of the reference's norm of that leaf and of the median leaf.
Leaves whose reference gradient is below a thousandth of the median
leaf's move by round-off alone and are left out of the change.
"""

from __future__ import annotations

import numpy as np
import torch

from .reference import qat_vit
from .reference import vit as vit_ref
from .reference.weights import generator


class Job:
    """The inputs of a training run, from the seed."""

    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, int(seed), torch.device(device)
        self.model = cell.model
        t = cell.traffic
        self.batch, n = int(t["batch"]), int(t["pool"])
        gen = generator(seed, self.device)
        self.weights = qat_vit.named_params(vit_ref.make_params(self.model, gen, self.device))
        img, classes = self.model["img_size"], self.model["num_classes"]
        self.images = [torch.randn((self.batch, img, img, 3), generator=gen, device=self.device) for _ in range(n)]
        self.labels = [torch.randint(0, classes, (self.batch,), generator=gen, device=self.device) for _ in range(n)]

    def inputs(self, i: int):
        """Step ``i``'s batch, its mixup generator and its drop-path generator."""
        k = i % len(self.images)
        mix = np.random.default_rng((self.seed, 0, i, 0))
        drop_seed = int(np.random.default_rng((self.seed, 0, i, 1)).integers(2**62))
        return self.images[k], self.labels[k], mix, torch.Generator(device=self.device).manual_seed(drop_seed)


class Program:
    """The program's train step (``train.steps.make_train_step``) on the
    QAT model (``models.create_model``) carrying the job's weights."""

    def __init__(self, job: Job):
        from ivit_tpu_torch.models import create_model
        from ivit_tpu_torch.train import AdamW, MixupConfig, create_train_state, make_train_step, mixup_cutmix

        tr, t = job.cell.config["train"], job.cell.traffic
        m = job.model
        model = create_model(tr["model"], device=job.device, drop_path_rate=float(t["drop_path_rate"]), **m)
        params = dict(model.named_parameters())
        if set(params) != set(job.weights):
            raise ValueError(f"the model's parameters differ from the job's: {sorted(set(params) ^ set(job.weights))}")
        with torch.no_grad():
            for name, p in params.items():
                p.copy_(job.weights[name])
        self.names = list(params)
        tx = AdamW(float(tr["lr"]), b1=tr["betas"][0], b2=tr["betas"][1], eps=float(tr["eps"]),
                   weight_decay=float(tr["weight_decay"]))
        self.state = create_train_state(model, tx, ema_decay=0.0, device=job.device)
        self.step_fn = make_train_step(model, ema_decay=0.0, grad_clip=None)
        self.mix_cfg = MixupConfig(mixup_alpha=float(t["mixup"]), cutmix_alpha=float(t["cutmix"]),
                                   switch_prob=float(t["switch_prob"]), label_smoothing=float(t["smoothing"]),
                                   num_classes=m["num_classes"])
        self.mixup_cutmix = mixup_cutmix
        self.job = job

    def step(self, i: int, span) -> float:
        """Step ``i`` as ``quant_train`` runs it; returns its loss, read on
        the host."""
        images, labels, mix, drop = self.job.inputs(i)
        with span("mixup"):
            images, targets = self.mixup_cutmix(images, labels, self.mix_cfg, mix, device=self.job.device)
        with span("step"):
            self.state, metrics = self.step_fn(self.state, images, targets, drop)
        with span("loss_read"):
            return float(metrics["loss"])

    def params(self) -> dict:
        return {n: p.detach().clone() for n, p in zip(self.names, self.state.model.parameters())}

    def first_gradient(self) -> dict:
        """The gradient the optimizer took at step 1, from its first
        moment: μ₁ = (1 − β1)·g."""
        b1 = self.state.tx.b1
        return {n: m / (1 - b1) for n, m in zip(self.names, self.state.opt_state.mu)}


def checked_steps(prog: Program, steps: int, span) -> dict:
    """The program's first ``steps`` steps, as the comparison reads them:
    ``{"losses", "grad1", "params"}``."""
    losses, grad1 = [], None
    for i in range(steps):
        losses.append(prog.step(i, span))
        if i == 0:
            grad1 = prog.first_gradient()
    return {"losses": losses, "grad1": grad1, "params": prog.params()}


def run_reference(job: Job, steps: int, tf32: bool = False, half_batch: bool = False) -> dict:
    """The reference's first ``steps`` steps from the job's weights:
    ``{"losses", "grad1", "params"}``. ``tf32`` is the lower-precision
    control, ``half_batch`` a planted fault."""
    tr, t = job.cell.config["train"], job.cell.traffic
    model = qat_vit.VisionTransformer(job.model, float(t["drop_path_rate"])).to(job.device)
    params = dict(model.named_parameters())
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(job.weights[name])
    names = list(params)
    opt = qat_vit.AdamW(list(params.values()), float(tr["lr"]), tr["betas"][0], tr["betas"][1], float(tr["eps"]),
                        float(tr["weight_decay"]))
    classes, img = job.model["num_classes"], job.model["img_size"]
    losses, grad1 = [], None
    qat_vit.Precision.tf32 = tf32
    try:
        for i in range(steps):
            images, labels, mix, drop = job.inputs(i)
            d = qat_vit.draw_mixup(float(t["mixup"]), float(t["cutmix"]), float(t["switch_prob"]), img, img, mix)
            images, targets = qat_vit.mixup(images, labels, classes, float(t["smoothing"]), d)
            losses.append(float(qat_vit.train_step(model, opt, images, targets, drop, half_batch)))
            if i == 0:
                grad1 = {n: m / (1 - opt.b1) for n, m in zip(names, opt.mu)}
    finally:
        qat_vit.Precision.tf32 = False
    return {"losses": losses, "grad1": grad1, "params": {n: p.detach().clone() for n, p in params.items()}}


def _worst_leaf(prog: dict, ref: dict, names) -> float:
    norms = {n: float(torch.linalg.vector_norm(ref[n].double())) for n in names}
    median = float(np.median(list(norms.values())))
    worst = 0.0
    for n in names:
        gap = abs(float(torch.linalg.vector_norm(prog[n].double())) - norms[n])
        worst = max(worst, gap / max(norms[n], median, 1e-30))
    return worst


def compare(prog: dict, ref: dict, weights: dict) -> dict:
    """The numbers compared: ``loss_gap`` (the worst checked step's loss
    gap over the reference's loss), ``grad_gap`` and ``change_gap``."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))
    names = list(ref["grad1"])
    grad_gap = _worst_leaf(prog["grad1"], ref["grad1"], names)
    gnorm = {n: float(torch.linalg.vector_norm(ref["grad1"][n].double())) for n in names}
    median = float(np.median(list(gnorm.values())))
    moved = [n for n in names if gnorm[n] >= 1e-3 * median]
    prog_change = {n: prog["params"][n] - weights[n] for n in moved}
    ref_change = {n: ref["params"][n] - weights[n] for n in moved}
    return {"loss_gap": loss_gap, "grad_gap": grad_gap, "change_gap": _worst_leaf(prog_change, ref_change, moved)}
