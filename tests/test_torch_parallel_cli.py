"""The port's multi-process entry points on CPU ranks, launched as a user
launches them: ``python -m torch.distributed.run --standalone
--nproc-per-node 2 -m ivit_tpu_torch.<cli>`` (``gloo`` with ``--device
cpu``), against the single-process runs in this process.

* ``quant_train --distributed --zero1``, two epochs of one step at the
  tiny size of ``tests/test_torch_train_cli.py``: its checkpoint against
  the single-process run's; and the same launch resumed from the
  single-process run's epoch-0 checkpoint against both (a checkpoint of
  either kind resumes under the other: both hold optax's layout, whole).
  The ranges and every count are equal; the parameters, their EMA and
  the moments agree to within the rounding of the data-parallel
  gradient's all-reduce, with the bounds of
  ``tests/test_torch_parallel_train.py`` (the first moment standing in
  for the gradient where the bound depends on it). Two steps, as there:
  the QAT weights are requantized every step, so after a few more a
  weight that the rounding left beside an int8 boundary can take the
  other side on one path, and the forwards themselves part.
* ``evaluate_accuracy --mesh-data 2`` and ``--mesh-model 2`` on the
  single-process run's converted artifact, at batches of 15 (padded to
  16 for the data axis with a copy of their first image): the same FINAL
  line and dumped logits equal, tolerance 0, to the single-process
  sweep.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ivit_tpu_torch import convert_model, evaluate_accuracy, quant_train
from ivit_tpu_torch import utils as port_utils
from ivit_tpu_torch.nn.flax_state import flatten
from ivit_tpu_torch.utils import load_checkpoint_raw

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 1e-4
BASE = ["--model", "deit_tiny", "--data-set", "SYNTHETIC", "--input-size", "32", "--nb-classes", "10",
        "--batch-size", "8", "--max-steps-per-epoch", "1", "--epochs", "2", "--aa", "none", "--color-jitter", "0",
        "--num-workers", "2", "--device", "cpu", "--lr", str(LR), "--best-acc1", "-1", "--model-ema",
        "--model-ema-decay", "0.9"]
EVAL = ["--model", "deit_tiny", "--data-set", "SYNTHETIC", "--input-size", "32", "--nb-classes", "10",
        "--batch-size", "15", "--max-batches", "3", "--num-workers", "2", "--device", "cpu"]
# the bounds of tests/test_torch_parallel_train.py, at this run's lr
GRAD_RTOL, SMALL_GRAD = 1e-5, 1e-2
PARAM_ATOL, ADAM_ATOL = 1e-3 * LR, 2 * 3 * LR


def _torchrun(module: str, args: list, n: int = 2) -> str:
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(var, None)
    proc = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone", f"--nproc-per-node={n}",
                           "-m", module, *args], cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc.stdout


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The single-process run (its rolling checkpoint also kept at each
    epoch), the distributed ZeRO-1 run, and that run resumed from the
    single-process epoch-0 checkpoint."""
    single, dist, resumed = (tmp_path_factory.mktemp(k) for k in ("single", "dist", "resumed"))
    real = port_utils.save_checkpoint

    def keep_each_epoch(path, state, extra=None):
        real(path, state, extra)
        if path.endswith("checkpoint.pkl"):
            real(path.replace(".pkl", f".e{extra['epoch']}.pkl"), state, extra)

    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(port_utils, "save_checkpoint", keep_each_epoch)
            quant_train.main(BASE + ["--output-dir", str(single)])
    finally:
        torch.set_num_threads(prev)
    _torchrun("ivit_tpu_torch.quant_train", BASE + ["--distributed", "--zero1", "--output-dir", str(dist)])
    _torchrun("ivit_tpu_torch.quant_train", BASE + ["--distributed", "--zero1", "--output-dir", str(resumed),
                                                    "--resume", str(single / "checkpoint.e0.pkl")])
    return single, dist, resumed


def _assert_checkpoints_agree(got_path, want_path):
    got, got_extra = load_checkpoint_raw(str(got_path))
    want, want_extra = load_checkpoint_raw(str(want_path))
    assert got_extra == want_extra
    assert int(got["step"]) == int(want["step"])
    g, w = flatten(got), flatten(want)
    assert g.keys() == w.keys()
    mu = {k.split(".mu.", 1)[1]: v for k, v in w.items() if ".mu." in k}
    for key, want_v in w.items():
        got_v, want_v = np.asarray(g[key]), np.asarray(want_v)
        if key.startswith("quant_stats.") or want_v.dtype.kind in "iu":
            np.testing.assert_array_equal(got_v, want_v, err_msg=key)
        elif ".mu." in key or ".nu." in key:
            rtol = GRAD_RTOL if ".mu." in key else 2 * GRAD_RTOL
            np.testing.assert_allclose(got_v, want_v, rtol=0, atol=rtol * np.abs(want_v).max(), err_msg=key)
        else:  # params, ema_params
            leaf = key.split(".", 1)[1]
            m = np.abs(mu[leaf])
            atol = np.where(m >= SMALL_GRAD * m.max(), PARAM_ATOL, ADAM_ATOL)
            assert np.all(np.abs(got_v - want_v) <= atol + 2.0**-22 * np.abs(want_v)), key


def test_distributed_zero1_checkpoint_equals_single_process(runs):
    single, dist, _ = runs
    assert "ZeRO-1" in (dist / "log.log").read_text()
    _assert_checkpoints_agree(dist / "checkpoint.pkl", single / "checkpoint.pkl")


def test_distributed_resume_equals_the_uninterrupted_runs(runs):
    """The ZeRO-1 launch resumed at epoch 1 from the single-process
    epoch-0 checkpoint against the uninterrupted single-process and
    distributed runs."""
    single, dist, resumed = runs
    assert "resumed from" in (resumed / "log.log").read_text()
    _assert_checkpoints_agree(resumed / "checkpoint.pkl", single / "checkpoint.pkl")
    _assert_checkpoints_agree(resumed / "checkpoint.pkl", dist / "checkpoint.pkl")


@pytest.fixture(scope="module")
def served(runs, tmp_path_factory):
    single = runs[0]
    out = tmp_path_factory.mktemp("served")
    artifact = str(out / "artifact.pkl")
    convert_model.main(["--checkpoint", str(single / "checkpoint.pkl"), "--output", artifact, "--device", "cpu"])
    evaluate_accuracy.main(EVAL + ["--artifact", artifact, "--dump-logits", str(out / "single.npz")])
    return artifact, out


@pytest.mark.parametrize("mesh", [["--mesh-data", "2"], ["--mesh-model", "2"]], ids=lambda m: m[0])
def test_evaluate_accuracy_on_a_mesh_equals_single_process(served, mesh, capsys):
    artifact, out = served
    dump = out / f"{mesh[0][2:]}.npz"
    stdout = _torchrun("ivit_tpu_torch.evaluate_accuracy", EVAL + mesh + ["--artifact", artifact,
                                                                         "--dump-logits", str(dump)])
    finals = [line for line in stdout.splitlines() if line.startswith("FINAL")]
    single = np.load(out / "single.npz")
    got = np.load(dump)
    np.testing.assert_array_equal(got["logits"], single["logits"])
    np.testing.assert_array_equal(got["labels"], single["labels"])
    assert len(finals) == 1 and "over 45" in finals[0]  # rank 0 alone prints
    logits, labels = single["logits"], single["labels"]
    top1 = 100 * float((logits.argmax(-1) == labels).sum()) / len(labels)
    assert finals[0].startswith(f"FINAL top1 {top1:.3f}")
