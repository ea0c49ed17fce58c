"""What the serving loops share: the served model made from the seed, its
pool of inputs in pinned host memory, and the comparison of every answer
with the plain reference.

The benchmark draws the model's float weights and the images from the
seed on the device, freezes the weights into an artifact with the
reference family's own calibration, and hands that artifact to the
program's engine (the configuration's ``serve_entry``). The reference
works out everything else from the artifact again. Every answer the
timed loop reads back is held against the first answer of the same
input (``answers_differing``: the served path is deterministic), and
each first answer against the reference (``logit_gap``).
"""

from __future__ import annotations

import importlib
import time

import torch

from . import spec
from .reference.weights import generator


def entry(path: str):
    """``"package.module:function"`` → the function."""
    module, _, name = path.partition(":")
    return getattr(importlib.import_module(module), name)


class Served:
    """The cell's model, frozen from the seed and built by the program."""

    def __init__(self, cell: spec.Cell, seed: int, device):
        self.cell, self.device = cell, torch.device(device)
        self.model = cell.model
        self.family = spec.load_module("reference", cell.config["family"], cell.root)
        self.gen = generator(seed, self.device)
        params = self.family.make_params(self.model, self.gen, self.device)
        img = self.model["img_size"]
        calib = torch.randn((2, img, img, 3), generator=self.gen, device=self.device)
        self.artifact = self.family.calibrate(self.model, params, calib)
        del params, calib
        build = entry(cell.config["serve_entry"])
        self.infer = build(self.artifact, device=self.device, kernels=tuple(cell.config["kernels"]))

    def pool(self, n: int, batch: int) -> torch.Tensor:
        """``n`` inputs of ``batch`` seeded NHWC float32 images each, in
        pinned host memory (pinned only where there is a card)."""
        img = self.model["img_size"]
        shape = (n, batch, img, img, 3)
        out = torch.empty(shape, dtype=torch.float32, pin_memory=self.device.type == "cuda")
        for i in range(n):
            out[i].copy_(torch.randn(shape[1:], generator=self.gen, device=self.device))
        return out

    def capture(self, batch: int):
        """The timed entry: a CUDA-graph capture of the engine at
        ``batch`` (``deploy.graphs.capture_infer``); on the CPU, where
        nothing is captured, the eager engine."""
        if self.device.type == "cuda":
            from ivit_tpu_torch.deploy.graphs import capture_infer

            return capture_infer(self.infer, batch, self.model["img_size"], device=self.device)
        infer = self.infer
        return lambda x: infer(x).clone()

    def release(self) -> None:
        """Drop the program's engine before the reference runs."""
        self.infer = None
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()

    def logit_gap(self, answers: dict, pool: torch.Tensor, weight_bits: int = 8, rows: int = 128) -> float:
        """The widest gap between the served logits ``answers`` (pool index
        → host logits of that input) and the reference's, each image's
        largest difference over its largest reference logit; the
        reference runs in blocks of at most ``rows`` images."""
        t = self.family.carry(self.artifact, self.device)
        keys = sorted(answers)
        served = torch.cat([answers[k] for k in keys])
        images = torch.cat([pool[k] for k in keys])
        worst = 0.0
        for i in range(0, images.shape[0], rows):
            ref = self.family.forward(t, images[i:i + rows].to(self.device), weight_bits).cpu()
            gap = (served[i:i + rows] - ref).abs().amax(1) / ref.abs().amax(1).clamp(min=1e-30)
            worst = max(worst, float(gap.max()))
        return worst


def run_loop(run, cell, make_loop, measure) -> dict:
    """A serving cell's run: set-up (the served model, then
    ``make_loop(run, served, traffic)``, whose constructor fills the pool
    and captures the timed entry, then its warm-up), the traced window
    where asked, the measured window, then the comparison.
    ``measure(loop.pump(deadline=...), start)`` gives the end-to-end
    metrics of the window."""
    served = Served(cell, run.seed, run.device)
    run.mark("weights, artifact and engine")
    loop = make_loop(run, served, cell.traffic)
    run.mark("capture")
    loop.pump(units=int(cell.traffic["warmup"]))
    run.mark("warm-up")
    setup_s = time.perf_counter() - run.t_start
    view = None
    if run.trace:
        n = int(cell.traffic["trace_units"])
        view = run.traced(lambda: loop.pump(units=n), units=n, images=n * loop.batch)
    t0 = time.perf_counter()
    end_to_end = measure(loop.pump(deadline=t0 + run.seconds), t0)
    memory = run.memory_peak()
    loop.replay = None
    served.release()
    return {
        "setup_s": setup_s, "end_to_end": end_to_end, "attempted": loop.issued, "failed": loop.differing,
        "checks": {"logit_gap": served.logit_gap(loop.first, loop.pool), "answers_differing": loop.differing},
        "view": view, "memory_peak_bytes": memory,
    }
