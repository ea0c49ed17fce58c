"""``ivit_tpu_torch.quant_train --pipe N`` (GPipe over a ``(data, pipe)``
mesh), the port's side of ``tests/test_pipe_cli.py``.

* JAX's four guards, in process and in JAX's words: a Swin ("ViT
  family"), ``--mesh-model`` ("exclusive"), a depth the stages do not
  divide ("depth"), no range source ("frozen-range"); then a world the
  stages do not divide, and a batch no microbatch count splits.
* One torchrun launch of two CPU ranks, ``--distributed --pipe 2
  --calib-batches 1`` on deit_tiny at 32 px: the checkpoint records
  ``pipe`` 2 and holds the whole model, ``blocks_0`` … ``blocks_11``.
* ``slow``, as JAX's end-to-end test: that checkpoint evaluates through
  the standard path, and resumes into another pipelined run.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from ivit_tpu_torch import quant_train
from ivit_tpu_torch.utils import load_checkpoint_raw
from tests.torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = ["--model", "deit_tiny", "--data-set", "SYNTHETIC", "--nb-classes", "10", "--input-size", "32",
        "--batch-size", "16", "--lr", "1e-4", "--num-workers", "0", "--drop-path", "0.0", "--aa", "none",
        "--color-jitter", "0", "--device", "cpu"]
RUN = ["--pipe", "2", "--calib-batches", "1", "--epochs", "1", "--max-steps-per-epoch", "2"]


def _torchrun(args: list, n: int = 2) -> None:
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(var, None)
    proc = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone", f"--nproc-per-node={n}",
                           "-m", "ivit_tpu_torch.quant_train", "--distributed", *args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]


@pytest.mark.parametrize("argv,match", [
    (["--model", "swin_tiny", "--window-size", "4", "--pipe", "2", "--calib-batches", "1"], "ViT family"),
    (["--pipe", "2", "--mesh-model", "2", "--calib-batches", "1"], "exclusive"),
    (["--pipe", "5", "--calib-batches", "1", "--epochs", "1"], "depth"),
    (["--pipe", "2", "--epochs", "1"], "frozen-range"),
    (["--pipe", "2", "--calib-batches", "1"], "does not divide the 1-rank world"),
    (["--pipe", "3", "--calib-batches", "1", "--model", "deit_tiny_fp32"], "float model"),
], ids=["swin", "exclusive", "depth", "frozen-range", "world", "float"])
def test_pipe_guards_exit_in_jax_order(argv, match, tmp_path, monkeypatch):
    """Each guard exits before any log is written, in JAX's order: the
    frozen-range case also has a stage count the world of one does not
    divide, and exits naming the ranges."""
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(SystemExit, match=match):
        quant_train.main(BASE + argv + ["--output-dir", str(tmp_path)])
    assert not (tmp_path / "log.log").exists()


def test_pipe_microbatch_count(monkeypatch):
    """``--pipe-microbatches 0`` takes the largest M ≤ 2·pipe that splits
    the batch into multiples of the data axis; a count that cannot exits
    in JAX's words."""
    args = quant_train.build_parser().parse_args(BASE + ["--pipe", "2", "--calib-batches", "1"])
    assert quant_train.pipe_layout(args, 4) == (2, 4)
    args.batch_size = 6
    assert quant_train.pipe_layout(args, 4) == (2, 3)
    args.pipe_microbatches = 2
    with pytest.raises(SystemExit, match="no valid microbatch count: batch 6 must split into M microbatches of a "
                                         "multiple of data=2 rows"):
        quant_train.pipe_layout(args, 4)


@pytest.fixture(scope="module")
def pipe_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("pipe")
    _torchrun(BASE + RUN + ["--output-dir", str(out)])
    return out


def test_pipe_run_checkpoint_holds_the_whole_model(pipe_run):
    """Two ranks, one stage each: the rolling checkpoint records pipe 2
    and epoch 0 and holds every block (``blocks_0`` … ``blocks_11``) with
    its moments; the pipelined validation wrote ``best.pkl``."""
    raw, extra = load_checkpoint_raw(str(pipe_run / "checkpoint.pkl"))
    assert extra["pipe"] == 2 and extra["epoch"] == 0
    blocks = {k for k in raw["params"] if k.startswith("blocks_")}
    assert blocks == {f"blocks_{i}" for i in range(12)}
    assert set(raw["opt_state"]["0"]["mu"]) == set(raw["params"])
    assert int(raw["step"]) == 2
    assert "pipeline parallelism: (data=1, pipe=2) mesh, 4 microbatches/step" in (pipe_run / "log.log").read_text()
    assert (pipe_run / "best.pkl").exists()


@pytest.mark.slow
def test_pipe_e2e_synthetic(pipe_run, tmp_path):
    """The pipelined run's checkpoint evaluates through the standard path
    (the same spec record, the same layout), and resumes into another
    pipelined run (``--resume`` satisfies the frozen-range guard) that
    trains epoch 1."""
    ckpt = str(pipe_run / "checkpoint.pkl")
    acc = quant_train.main(BASE + ["--eval", "--resume", ckpt, "--output-dir", str(tmp_path)])
    assert np.isfinite(acc)
    _torchrun(BASE + ["--pipe", "2", "--resume", ckpt, "--epochs", "2", "--max-steps-per-epoch", "2",
                      "--output-dir", str(tmp_path)])
    _, extra = load_checkpoint_raw(str(tmp_path / "checkpoint.pkl"))
    assert extra["epoch"] == 1 and extra["pipe"] == 2
