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
* ``quant_train --distributed --mesh-model 2`` (tensor parallelism) on a
  DeiT-S at the same tiny input, whose 6 heads the model axis divides:
  two ranks, then four with ``--seq-parallel --zero1`` (a ``(2, 2)``
  mesh), then two resumed from the single-process epoch-0 checkpoint;
  each checkpoint within the same bounds of the single-process run's
  (the tensor-parallel gradient sums its float32 parts in another
  order). ``convert_model --checkpoint`` reads the tensor-parallel
  checkpoint as any other: its artifact equals the one of the same
  variables written by a single-process state. A model axis that does
  not divide the world exits naming WORLD_SIZE; ``--pipe 2`` with a
  model axis exits as JAX's guard does (the pipeline itself:
  ``tests/test_torch_pipe_cli.py``).
* ``quant_train --distributed --mesh-model 2 --seq-parallel`` on the
  float DeiT-S (``deit_small_fp32``) and on a Swin-T: both train
  tensor-parallel with ``--seq-parallel`` ignored and JAX's warning
  logged; the float run's checkpoint within the same bounds of its
  single-process run's.
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
from tests.torch_threads import one_torch_thread  # noqa: F401

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
# DeiT-S's tensor-parallel gradient sums more float32 parts in another
# order: an entry at SMALL_GRAD of its leaf's largest may then be off by
# GRAD_RTOL / SMALL_GRAD = 1e-3 of itself, and where the two steps'
# gradients partly cancel in Adam's m the ratio m/sqrt(v) moves by a few
# times that: 10 x 1e-3 x lr over the two steps
TP_PARAM_ATOL = 10 * GRAD_RTOL / SMALL_GRAD * LR


def _torchrun(module: str, args: list, n: int = 2, ok: bool = True) -> str:
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(var, None)
    proc = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone", f"--nproc-per-node={n}",
                           "-m", module, *args], cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert (proc.returncode == 0) == ok, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc.stdout if ok else proc.stderr


def _single_run(argv: list) -> None:
    """The single-process run of ``argv`` in this process, its rolling
    checkpoint also kept at each epoch (``checkpoint.e<epoch>.pkl``)."""
    real = port_utils.save_checkpoint

    def keep_each_epoch(path, state, extra=None):
        real(path, state, extra)
        if path.endswith("checkpoint.pkl"):
            real(path.replace(".pkl", f".e{extra['epoch']}.pkl"), state, extra)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_utils, "save_checkpoint", keep_each_epoch)
        quant_train.main(argv)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The single-process run, the distributed ZeRO-1 run, and that run
    resumed from the single-process epoch-0 checkpoint."""
    single, dist, resumed = (tmp_path_factory.mktemp(k) for k in ("single", "dist", "resumed"))
    _single_run(BASE + ["--output-dir", str(single)])
    _torchrun("ivit_tpu_torch.quant_train", BASE + ["--distributed", "--zero1", "--output-dir", str(dist)])
    _torchrun("ivit_tpu_torch.quant_train", BASE + ["--distributed", "--zero1", "--output-dir", str(resumed),
                                                    "--resume", str(single / "checkpoint.e0.pkl")])
    return single, dist, resumed


def _assert_checkpoints_agree(got_path, want_path, param_atol=PARAM_ATOL):
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
            atol = np.where(m >= SMALL_GRAD * m.max(), param_atol, ADAM_ATOL)
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


TP = [a if a != "deit_tiny" else "deit_small" for a in BASE]


@pytest.fixture(scope="module")
def tp_runs(tmp_path_factory):
    """DeiT-S: the single-process run, the tensor-parallel run on two
    ranks, the sequence-parallel ZeRO-1 run on a (2, 2) mesh of four, and
    the tensor-parallel run resumed from the single-process epoch-0
    checkpoint."""
    single, tp, sp, resumed = (tmp_path_factory.mktemp(k) for k in ("tp_single", "tp", "sp", "tp_resumed"))
    _single_run(TP + ["--output-dir", str(single)])
    _torchrun("ivit_tpu_torch.quant_train", TP + ["--distributed", "--mesh-model", "2", "--output-dir", str(tp)])
    _torchrun("ivit_tpu_torch.quant_train", TP + ["--distributed", "--mesh-model", "2", "--seq-parallel", "--zero1",
                                                  "--output-dir", str(sp)], n=4)
    _torchrun("ivit_tpu_torch.quant_train", TP + ["--distributed", "--mesh-model", "2", "--output-dir", str(resumed),
                                                  "--resume", str(single / "checkpoint.e0.pkl")])
    return single, tp, sp, resumed


def test_tensor_parallel_checkpoint_equals_single_process(tp_runs):
    single, tp, _, _ = tp_runs
    assert "a (data=1, model=2) mesh" in (tp / "log.log").read_text()
    _assert_checkpoints_agree(tp / "checkpoint.pkl", single / "checkpoint.pkl", TP_PARAM_ATOL)


def test_sequence_parallel_zero1_checkpoint_equals_single_process(tp_runs):
    single, _, sp, _ = tp_runs
    log = (sp / "log.log").read_text()
    assert "a (data=2, model=2) mesh, ZeRO-1" in log and "sequence parallel" in log
    _assert_checkpoints_agree(sp / "checkpoint.pkl", single / "checkpoint.pkl", TP_PARAM_ATOL)


def test_tensor_parallel_resume_equals_the_uninterrupted_runs(tp_runs):
    single, tp, _, resumed = tp_runs
    assert "resumed from" in (resumed / "log.log").read_text()
    _assert_checkpoints_agree(resumed / "checkpoint.pkl", single / "checkpoint.pkl", TP_PARAM_ATOL)
    _assert_checkpoints_agree(resumed / "checkpoint.pkl", tp / "checkpoint.pkl", TP_PARAM_ATOL)


def test_convert_reads_a_tensor_parallel_checkpoint(tp_runs, tmp_path):
    """``convert_model --checkpoint`` on the tensor-parallel checkpoint,
    and on the same variables saved by a single-process train state:
    equal artifacts."""
    import pickle

    from ivit_tpu_torch.models import create_model
    from ivit_tpu_torch.train import AdamW, create_train_state
    from ivit_tpu_torch.utils import load_checkpoint, save_checkpoint

    tp = tp_runs[1] / "checkpoint.pkl"
    _, extra = load_checkpoint_raw(str(tp))
    model = create_model("deit_small", device="cpu", num_classes=10, img_size=32)
    state, _ = load_checkpoint(str(tp), create_train_state(model, AdamW(LR), ema_decay=0.9, device="cpu"))
    save_checkpoint(str(tmp_path / "single.pkl"), state, extra)
    arts = []
    for ckpt, name in ((tp, "tp"), (tmp_path / "single.pkl", "single")):
        convert_model.main(["--checkpoint", str(ckpt), "--output", str(tmp_path / f"{name}.pkl"), "--device", "cpu"])
        with open(tmp_path / f"{name}.pkl", "rb") as f:
            arts.append(pickle.load(f))

    def equal(a, b, path):
        if isinstance(b, dict):
            assert a.keys() == b.keys(), path
            for k in b:
                equal(a[k], b[k], f"{path}/{k}")
        elif isinstance(b, (list, tuple)):
            assert len(a) == len(b), path
            for i, (u, v) in enumerate(zip(a, b)):
                equal(u, v, f"{path}/{i}")
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=path)

    equal(*arts, "artifact")


FLOAT = [a if a != "deit_tiny" else "deit_small_fp32" for a in BASE]
SEQ_IGNORED = "--seq-parallel ignored (needs --mesh-model > 1 and a ViT-family model)"


@pytest.fixture(scope="module")
def float_runs(tmp_path_factory):
    """The float DeiT-S: the single-process run, and the tensor-parallel
    run on two ranks with ``--seq-parallel`` (ignored)."""
    single, tp = (tmp_path_factory.mktemp(k) for k in ("fp32_single", "fp32_tp"))
    _single_run(FLOAT + ["--output-dir", str(single)])
    _torchrun("ivit_tpu_torch.quant_train", FLOAT + ["--distributed", "--mesh-model", "2", "--seq-parallel",
                                                     "--output-dir", str(tp)])
    return single, tp


def test_float_model_tensor_parallel_checkpoint_equals_single_process(float_runs):
    single, tp = float_runs
    log = (tp / "log.log").read_text()
    assert SEQ_IGNORED in log and "tensor parallelism: deit_small_fp32 over the 2-way model axis\n" in log
    _assert_checkpoints_agree(tp / "checkpoint.pkl", single / "checkpoint.pkl", TP_PARAM_ATOL)


def test_seq_parallel_is_ignored_for_a_swin(tmp_path):
    swin = [a if a != "deit_tiny" else "swin_tiny" for a in BASE] + ["--window-size", "2"]
    _torchrun("ivit_tpu_torch.quant_train", swin + ["--distributed", "--mesh-model", "2", "--seq-parallel",
                                                    "--output-dir", str(tmp_path)])
    log = (tmp_path / "log.log").read_text()
    assert SEQ_IGNORED in log and "tensor parallelism: swin_tiny over the 2-way model axis\n" in log
    assert (tmp_path / "checkpoint.pkl").exists()


def test_model_axis_not_dividing_the_world_exits(tmp_path):
    stderr = _torchrun("ivit_tpu_torch.quant_train", TP + ["--distributed", "--mesh-model", "3",
                                                           "--output-dir", str(tmp_path)], ok=False)
    assert "--mesh-model 3 does not divide the world: mesh 0x3 != WORLD_SIZE 2 ranks" in stderr


def test_pipe_exits_naming_gpipe(tmp_path):
    """``--pipe`` with a model axis exits as JAX's CLI does: the pipeline
    manages its own (data, pipe) mesh."""
    with pytest.raises(SystemExit, match=r"--pipe is exclusive with --mesh-model/--seq-parallel/--zero1: the "
                                         r"pipeline manages its own \(data, pipe\) mesh"):
        quant_train.main(TP + ["--pipe", "2", "--mesh-model", "2", "--calib-batches", "1",
                               "--output-dir", str(tmp_path)])
    assert not (tmp_path / "log.log").exists()
