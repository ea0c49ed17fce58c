"""A whole run past the look for a card, with the timed path broken
underneath, comes out not correct: for each fault a cell can have."""

import pytest
import torch

from benchmark import serving, training
from benchmark.tests.tiny import execute, tiny_cell


def _break_replay(monkeypatch, fault):
    capture = serving.Served.capture

    def broken(self, batch):
        replay = capture(self, batch)

        def run(x):
            return fault(replay(x))

        return run

    monkeypatch.setattr(serving.Served, "capture", broken)


def _altered(logits):
    out = logits.clone()
    out[0, 0] += logits.abs().max()
    return out


def _half_left_out(logits):
    out = logits.clone()
    out[logits.shape[0] // 2:] = 0.0
    return out


@pytest.mark.parametrize("workload", ["deit_s.serve_b128", "swin_t.serve_b128", "deit_s.serve_b1"])
def test_sound_serving_is_correct(workload):
    assert execute(tiny_cell(workload))["correct"] is True


@pytest.mark.parametrize("workload, fault", [
    ("deit_s.serve_b128", _altered), ("swin_t.serve_b128", _altered), ("deit_s.serve_b1", _altered),
    ("deit_s.serve_b128", _half_left_out), ("swin_t.serve_b128", _half_left_out),
])
def test_broken_serving_is_not_correct(monkeypatch, workload, fault):
    _break_replay(monkeypatch, fault)
    assert execute(tiny_cell(workload))["correct"] is False


def test_sound_training_is_correct():
    assert execute(tiny_cell("deit_s.train_b128"))["correct"] is True


def _state_unchanged(step_fn):
    return lambda state, images, targets, gen: (state, {"loss": torch.tensor(2.3)})


def _half_batch(step_fn):
    def step(state, images, targets, gen):
        n = images.shape[0] // 2
        return step_fn(state, images[:n], targets[:n], gen)

    return step


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch])
def test_broken_training_is_not_correct(monkeypatch, fault):
    init = training.Program.__init__

    def broken(self, job):
        init(self, job)
        self.step_fn = fault(self.step_fn)

    monkeypatch.setattr(training.Program, "__init__", broken)
    assert execute(tiny_cell("deit_s.train_b128"))["correct"] is False


def test_traced_run_reads_its_window():
    r = execute(tiny_cell("deit_s.serve_b128"), trace=True)
    assert r["correct"] is True and r["trace"].window_s > 0 and r["trace"].units == 2
    assert set(r["trace"].breakdown) == {"device_ops", "idle_gaps"}
