"""The controls come out as not correct: the reference with its weights
rounded to 4 bits in the program's place (serving), and the faults a
training cell can have, at a tiny size on the CPU. The training control
(TF32 in the backward) exists only on the card (``test_bench_cuda.py``)."""

import pytest
import torch

from benchmark import control, training
from benchmark.tests.tiny import tiny_cell


@pytest.mark.parametrize("workload", ["deit_s.serve_b128", "swin_t.serve_b128", "deit_s.serve_b1"])
def test_int4_control_fails_the_limit(workload):
    cell = tiny_cell(workload)
    limit = cell.config["checks"]["serve"]["logit_gap"]
    got = control.serving(cell, 2**31 + 21, torch.device("cpu"))
    assert got["program"]["logit_gap"] <= limit < got["control_int4"]["logit_gap"]


def test_half_batch_fault_fails_the_limits():
    cell = tiny_cell("deit_s.train_b128")
    limits = cell.config["checks"]["train"]
    job = training.Job(cell, 2**31 + 23, "cpu")
    ref = training.run_reference(job, 3)
    got = training.compare(training.run_reference(job, 3, half_batch=True), ref, job.weights)
    assert any(got[k] > limits[k] for k in limits)
