"""The QAT step as ``quant_train`` runs it by default: each step draws
mixup or cutmix with smoothed targets (``train.augment.mixup_cutmix``),
then runs ``train.steps.make_train_step``'s step (drop-path, the ranges
moving, AdamW), and reads its loss on the host. Batches lie on the card
before the window; the input pipeline is not part of this loop.

Set-up builds the train state once and drives it through the first
``checked_steps`` steps on distinct batches, through the window's own
call; the reference follows those steps after the window. The window
then runs on the same state.

Traffic keys: ``batch``, ``pool`` (distinct batches, at least
``checked_steps``), ``checked_steps``, ``trace_units`` (the steps of a
traced window), ``drop_path_rate``, ``mixup``, ``cutmix``,
``switch_prob``, ``smoothing``.

End-to-end: ``train_images_per_s``, the images of the steps begun within
``--seconds``, over the time from the first step's start to the last
one's loss on the host (``stats``).
"""

from __future__ import annotations

import math
import time

import torch

from .. import stats
from ..training import Job, Program, checked_steps, compare, run_reference


def run(run, cell) -> dict:
    t = cell.traffic
    checked = int(t["checked_steps"])
    if int(t["pool"]) < checked:
        raise ValueError("the checked steps need distinct batches: pool >= checked_steps")
    job = Job(cell, run.seed, run.device)
    run.mark("weights and batches")
    prog = Program(job)
    run.mark("model and train state")
    checked_state = checked_steps(prog, checked, run.spans)
    run.mark("checked steps")
    setup_s = time.perf_counter() - run.t_start
    step = checked
    view = None
    if run.trace:
        n = int(t["trace_units"])

        def work():
            nonlocal step
            for _ in range(n):
                prog.step(step, run.spans)
                step += 1

        view = run.traced(work, units=n, images=n * job.batch)
    t0 = time.perf_counter()
    end = t0 + run.seconds
    done, failed = [], 0
    while time.perf_counter() < end:
        failed += not math.isfinite(prog.step(step, run.spans))
        done.append(time.perf_counter())
        step += 1
    memory = run.memory_peak()
    attempted = step
    del prog
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    gaps = compare(checked_state, run_reference(job, checked), job.weights)
    return {
        "setup_s": setup_s,
        "end_to_end": {"train_images_per_s": stats.rate(done, t0, job.batch)},
        "attempted": attempted, "failed": failed,
        "checks": gaps, "view": view, "memory_peak_bytes": memory,
    }
