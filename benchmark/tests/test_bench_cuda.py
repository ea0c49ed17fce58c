"""On the card (marked ``cuda``; skipped without one): each cell as
committed but cut to a small size runs correct through its timed path
and its traced window, and the training control (TF32 in the reference's
backward) fails a limit. ``python -m pytest benchmark/tests -m cuda`` runs
them there."""

import pytest
import torch

from benchmark import training
from benchmark.tests.tiny import execute, tiny_cell


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["deit_s.serve_b128", "swin_t.serve_b128", "deit_s.serve_b1",
                                      "deit_s.train_b128"])
def test_cell_on_the_card(card, workload):
    for trace in (False, True):
        r = execute(tiny_cell(workload), trace=trace, device=card)
        assert r["correct"] is True, r["checks"]
    assert r["trace"].window_s > r["trace"].busy_s > 0


@pytest.mark.cuda
def test_tf32_control_fails_a_limit(card):
    cell = tiny_cell("deit_s.train_b128")
    cell.config["model"].update(embed_dim=384, num_heads=6, img_size=64, patch_size=16, depth=2)
    cell.traffic.update(batch=32)
    limits = cell.config["checks"]["train"]
    job = training.Job(cell, 2**31 + 29, card)
    ref = training.run_reference(job, 3)
    got = training.compare(training.run_reference(job, 3, tf32=True), ref, job.weights)
    assert any(got[k] > limits[k] for k in limits), got
