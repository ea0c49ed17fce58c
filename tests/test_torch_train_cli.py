"""The port's trainer entry points on the CPU, end to end at a tiny size:
``quant_train``, ``convert_model --checkpoint`` and
``evaluate_accuracy`` (``--device cpu``), full-width ``deit_tiny`` at 32²
on the synthetic set with the Pillow-free flags.

* Train two epochs; separately, start the same run and kill it before
  the first step of epoch 1 (after epoch 0's rolling checkpoint), then
  ``--resume`` it: the resumed run's epoch-1 losses and its checkpoint
  (every parameter, range, moment, count and EMA leaf) equal the
  uninterrupted run's, tolerance 0. (A first run with ``--epochs 1``
  would not do: the cosine schedule spans ``--epochs``, so its epoch 0
  takes other learning rates from its third step on.)
* ``--eval --dump-logits``, convert, ``evaluate_accuracy
  --dump-logits``: the checks of ``tests/test_dump_logits.py`` (same
  labels in the same order, equal argmax) and the engine within 4 head
  scales of the simulator.
* SGD, calibration, the SIGTERM save, ``--profile-steps``, the refused
  flags (``--distributed`` outside torchrun, meshes wider than the
  world; the multi-GPU runs are ``tests/test_torch_parallel_cli.py``),
  the spec guard
  (``check_resume_spec``, the cases of ``tests/test_cli.py``) and the
  default device without a card.
* ``--pretrained`` from a seeded DeiT-Ti state dict on a 4×4 grid (the
  position embedding resized to the model's 2×2): every imported leaf
  in the checkpoint, the ranges calibrated, and ``--eval`` on it;
  ``--pretrained`` with a ``*_fp32`` name exits naming the guard; a
  ``*_fp32`` name trains; ``--fast-matmul`` trains, its first loss
  equal to the float32 run's, the switch off again after the run.
"""

import ast
import pickle
import re
import signal
import threading

import numpy as np
import pytest
import torch

from ivit_tpu_torch import convert_model, evaluate_accuracy, quant_train
from ivit_tpu_torch.models.import_torch import resize_pos_embed, torch_vit_to_params
from ivit_tpu_torch.nn import quant
from ivit_tpu_torch.nn.flax_state import flatten
from ivit_tpu_torch.utils import load_checkpoint_raw
from test_import import fake_torch_sd

STEPS = 3
BASE = ["--model", "deit_tiny", "--data-set", "SYNTHETIC", "--input-size", "32", "--nb-classes", "10",
        "--batch-size", "8", "--max-steps-per-epoch", str(STEPS), "--aa", "none", "--color-jitter", "0",
        "--num-workers", "2", "--device", "cpu", "--lr", "1e-4", "--best-acc1", "-1", "--model-ema",
        "--model-ema-decay", "0.9"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the models here are small, and the default
    pool's spinning threads would take the cores of the other test
    workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _losses(out_dir, epoch):
    text = (out_dir / "log.log").read_text()
    return re.findall(rf"epoch {epoch} losses (\[.*\])", text)[-1]


class _Killed(Exception):
    pass


def _killed_before_step(n):
    """``train.make_train_step`` whose steps raise at the n-th call."""
    from ivit_tpu_torch import train

    real, calls = train.make_train_step, []

    def make(*args, **kwargs):
        step = real(*args, **kwargs)

        def guarded(*step_args):
            if len(calls) == n:
                raise _Killed
            calls.append(n)
            return step(*step_args)

        return guarded

    return make


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """An uninterrupted two-epoch run, and the same run killed before
    epoch 1 then resumed."""
    from ivit_tpu_torch import train

    whole, split = tmp_path_factory.mktemp("whole"), tmp_path_factory.mktemp("split")
    quant_train.main(BASE + ["--epochs", "2", "--output-dir", str(whole)])
    with pytest.MonkeyPatch.context() as mp, pytest.raises(_Killed):
        mp.setattr(train, "make_train_step", _killed_before_step(STEPS))
        quant_train.main(BASE + ["--epochs", "2", "--output-dir", str(split)])
    first = load_checkpoint_raw(str(split / "checkpoint.pkl"))
    quant_train.main(BASE + ["--epochs", "2", "--output-dir", str(split), "--resume",
                             str(split / "checkpoint.pkl")])
    return whole, split, first


def test_train_writes_checkpoints_with_the_spec(runs):
    whole, split, (state, extra) = runs
    assert (whole / "checkpoint.pkl").exists() and (whole / "best.pkl").exists()
    assert extra == {"epoch": 0, "best_acc1": extra["best_acc1"], "model": "deit_tiny", "input_size": 32,
                     "nb_classes": 10, "softmax_bits": 16, "gelu_stable": False}
    assert int(state["step"]) == STEPS and int(state["opt_state"]["0"]["count"]) == STEPS
    assert state["ema_params"] is not None
    assert "epoch 0 done in" in (whole / "log.log").read_text()


def test_resume_equals_the_uninterrupted_run(runs):
    whole, split, _ = runs
    assert _losses(split, 1) == _losses(whole, 1)
    (a, ea), (b, eb) = (load_checkpoint_raw(str(d / "checkpoint.pkl")) for d in (split, whole))
    assert ea == eb and ea["epoch"] == 1
    fa, fb = flatten(a), flatten(b)
    assert fa.keys() == fb.keys()
    for name, v in fb.items():
        np.testing.assert_array_equal(fa[name], v, err_msg=name)


def test_eval_convert_and_evaluate_accuracy_agree(runs, tmp_path, capsys):
    whole, _, _ = runs
    ckpt = str(whole / "checkpoint.pkl")
    sim_npz, art, eng_npz = str(tmp_path / "sim.npz"), str(tmp_path / "artifact.pkl"), str(tmp_path / "eng.npz")
    acc = quant_train.main(BASE + ["--eval", "--resume", ckpt, "--dump-logits", sim_npz,
                                   "--output-dir", str(tmp_path)])
    convert_model.main(["--checkpoint", ckpt, "--output", art, "--device", "cpu"])
    capsys.readouterr()
    top1, top5, seen = evaluate_accuracy.main(["--model", "deit_tiny", "--artifact", art, "--data-set", "SYNTHETIC",
                                               "--input-size", "32", "--nb-classes", "10", "--batch-size", "32",
                                               "--num-workers", "2", "--dump-logits", eng_npz, "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "engine: kernels ['attention', 'layernorm']" and out[1] == "[32] top1 " + out[1].split("top1 ")[1]
    assert out[-2] == f"FINAL top1 {100 * top1 / seen:.3f} top5 {100 * top5 / seen:.3f} over 128"
    sim, eng = np.load(sim_npz), np.load(eng_npz)
    assert sim["logits"].shape == eng["logits"].shape == (128, 10)
    np.testing.assert_array_equal(sim["labels"], eng["labels"])
    with open(art, "rb") as f:
        head = float(np.max(pickle.load(f)["head"]["out_scale"]))
    assert np.abs(eng["logits"] - sim["logits"]).max() <= 4 * head
    np.testing.assert_array_equal(sim["logits"].argmax(-1), eng["logits"].argmax(-1))
    assert abs(acc - 100 * top1 / seen) < 1e-4


def test_evaluate_accuracy_max_batches(runs, tmp_path, capsys):
    whole, _, _ = runs
    art = str(tmp_path / "artifact.pkl")
    convert_model.main(["--checkpoint", str(whole / "best.pkl"), "--output", art, "--device", "cpu"])
    _, _, seen = evaluate_accuracy.main(["--model", "deit_tiny", "--artifact", art, "--data-set", "SYNTHETIC",
                                         "--input-size", "32", "--nb-classes", "10", "--batch-size", "24",
                                         "--max-batches", "2", "--num-workers", "1", "--device", "cpu"])
    assert seen == 48 and capsys.readouterr().out.splitlines()[-1].endswith("over 48")


def test_sgd_calibration_and_sigterm_save(tmp_path, monkeypatch):
    """``--opt sgd`` with ``--calib-batches``; a SIGTERM during the first
    step saves the rolling checkpoint (epoch −1, the step) and returns."""
    if threading.current_thread() is not threading.main_thread():
        pytest.skip("signal handlers are installed from the main thread only")
    from ivit_tpu_torch import train

    real = train.make_train_step

    def make_step(*a, **kw):
        step = real(*a, **kw)

        def preempted(*args):
            out = step(*args)
            signal.getsignal(signal.SIGTERM)(signal.SIGTERM, None)
            return out

        return preempted

    monkeypatch.setattr(train, "make_train_step", make_step)
    before = signal.getsignal(signal.SIGTERM)
    argv = [a for a in BASE if a not in ("--model-ema",)]
    argv = argv[: argv.index("--model-ema-decay")] + argv[argv.index("--model-ema-decay") + 2:]
    quant_train.main(argv + ["--opt", "sgd", "--epochs", "1", "--calib-batches", "1", "--output-dir", str(tmp_path)])
    assert signal.getsignal(signal.SIGTERM) == before  # the handler is restored
    state, extra = load_checkpoint_raw(str(tmp_path / "checkpoint.pkl"))
    assert extra["epoch"] == -1 and extra["preempted_step"] == 0 and int(state["step"]) == 1
    assert set(state["opt_state"]) == {"0", "1"} and "trace" in state["opt_state"]["1"]["0"]
    assert "preempted (signal 15) at epoch 0 step 0" in (tmp_path / "log.log").read_text()


def test_profile_steps_write_a_trace(tmp_path):
    """``--profile-steps 1``: step 10 of epoch 0 under torch.profiler, its
    trace in ``<output-dir>/profile``."""
    argv = BASE[: BASE.index("--batch-size")] + ["--batch-size", "4", "--max-steps-per-epoch", "11"]
    argv += BASE[BASE.index("--aa"):]
    quant_train.main(argv + ["--epochs", "1", "--profile-steps", "1", "--output-dir", str(tmp_path)])
    trace = tmp_path / "profile" / "trace.json"
    assert trace.exists() and '"traceEvents"' in trace.read_text()


# what each refused trainer flag's exit names: a ROADMAP item, or
# outside torchrun the environment it lacks. The multi-GPU flags run
# under torchrun now (tests/test_torch_parallel_cli.py,
# tests/test_torch_pipe_cli.py); in a world of one a model axis of 2
# exits naming WORLD_SIZE, as JAX's make_mesh raises on too few devices,
# and 2 pipeline stages exit naming the world, as JAX's n_dev % pipe.
REFUSALS = {"--pretrained": r"ROADMAP\.md §1 item \d", "--mesh-model": r"!= WORLD_SIZE 1 ranks",
            "--seq-parallel": r"!= WORLD_SIZE 1 ranks", "--pipe": r"--pipe 2 does not divide the 1-rank world",
            "--zero1": r"!= WORLD_SIZE 1 ranks", "--distributed": r"no torchrun environment \(RANK, WORLD_SIZE"}


@pytest.mark.parametrize("flag", [["--pretrained", "auto"], ["--mesh-model", "2"], ["--seq-parallel", "--mesh-model", "2"],
                                  ["--pipe", "2", "--calib-batches", "1"], ["--zero1", "--mesh-model", "2"],
                                  ["--distributed"]],
                         ids=lambda f: f[0])
def test_unported_trainer_flags_exit_with_their_roadmap_item(flag, tmp_path, monkeypatch):
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(SystemExit, match=REFUSALS[flag[0]]) as info:
        quant_train.main(BASE + flag + ["--output-dir", str(tmp_path)])
    assert ("--mesh-model 2" if "--mesh-model" in flag else flag[0]) in str(info.value.code)
    assert not (tmp_path / "log.log").exists()


# the first two ids keep the names they had while these flags were refused
@pytest.mark.parametrize("argv,match", [(["--mesh-data", "2"], r"= 2 ranks, but WORLD_SIZE is 1"),
                                        (["--mesh-model", "2"], r"= 2 ranks, but WORLD_SIZE is 1"),
                                        (["--weight-args"], "TPU-only")],
                         ids=["argv0-item 8", "argv1-item 8", "argv2-TPU-only"])
def test_unported_evaluate_flags_exit(argv, match, monkeypatch):
    """A mesh of more ranks than the world (one, outside torchrun) exits
    naming WORLD_SIZE; --weight-args is TPU-only."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(SystemExit, match=match):
        evaluate_accuracy.main(["--artifact", "a.pkl"] + argv)


def test_entry_points_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    argv = [a for a in BASE if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        quant_train.main(argv + ["--output-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evaluate_accuracy.main(["--artifact", "a.pkl"])


META = {"model": "deit_small", "input_size": 224, "nb_classes": 1000, "softmax_bits": 16, "gelu_stable": False}


@pytest.mark.parametrize("recorded,meta,model,match", [
    (dict(META, softmax_bits=8, gelu_stable=True), META, "deit_small", "softmax_bits"),
    (dict(META), META, "deit_small", None),
    ({"epoch": 3}, META, "deit_small", None),
    (dict(META, model="swin_tiny", softmax_bits=16, window_size=7), dict(META, model="swin_tiny", softmax_bits=8,
                                                                         window_size=7), "swin_tiny", None),
    (dict(META, input_size=384), META, "deit_small", "input_size"),
], ids=["mismatch", "match", "pre-metadata", "legacy-swin-softmax16", "geometry"])
def test_check_resume_spec(recorded, meta, model, match):
    if match is None:
        quant_train.check_resume_spec(recorded, meta, model)
    else:
        with pytest.raises(SystemExit, match=match):
            quant_train.check_resume_spec(recorded, meta, model)


def test_resume_with_another_spec_exits(runs, tmp_path):
    whole, _, _ = runs
    with pytest.raises(SystemExit, match="softmax_bits"):
        quant_train.main(BASE + ["--softmax-bits", "8", "--eval", "--resume", str(whole / "checkpoint.pkl"),
                                 "--output-dir", str(tmp_path)])


def _epoch0_losses(out_dir):
    return ast.literal_eval(_losses(out_dir, 0))


def _one_epoch(steps):
    argv = [a for a in BASE if a not in ("--model-ema",)]
    argv = argv[: argv.index("--model-ema-decay")] + argv[argv.index("--model-ema-decay") + 2:]
    i = argv.index("--max-steps-per-epoch")
    return argv[:i] + ["--max-steps-per-epoch", str(steps)] + argv[i + 2:] + ["--epochs", "1"]


def test_pretrained_imports_every_leaf(tmp_path):
    """A DeiT-Ti state dict (192 wide, 12 blocks, 10 classes) on a 4×4
    grid, ``{"model": ...}`` in a ``.pth``: with ``--lr 0`` the saved
    parameters are the import itself, every leaf equal to the importer's
    tree (the position embedding resized to 2×2), every range calibrated;
    ``--eval --pretrained`` evaluates it."""
    sd = fake_torch_sd(D=192, depth=12, heads=3, p=16, img=64, classes=10)
    path = str(tmp_path / "deit_tiny.pth")
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}}, path)
    argv = _one_epoch(2) + ["--pretrained", path, "--calib-batches", "1"]
    quant_train.main(argv + ["--lr", "0", "--output-dir", str(tmp_path / "train")])
    state, _ = load_checkpoint_raw(str(tmp_path / "train" / "checkpoint.pkl"))
    want = torch_vit_to_params(sd)
    want["pos_embed"] = resize_pos_embed(want["pos_embed"], 5)
    got, want = flatten(state["params"]), flatten(want)
    assert got.keys() == want.keys()
    for name, value in want.items():
        np.testing.assert_array_equal(got[name], value, err_msg=name)
    stats = flatten(state["quant_stats"])
    assert all(stats[k] < stats[k.replace("min_val", "max_val")] for k in stats if k.endswith("min_val"))
    assert "imported pretrained weights from" in (tmp_path / "train" / "log.log").read_text()
    acc = quant_train.main(argv + ["--eval", "--output-dir", str(tmp_path / "eval")])
    assert 0.0 <= acc <= 100.0


def test_pretrained_with_a_float_name_exits(tmp_path):
    argv = _one_epoch(1) + ["--model", "deit_tiny_fp32", "--pretrained", "x.pth", "--output-dir", str(tmp_path)]
    with pytest.raises(SystemExit, match=r"deit_tiny_fp32.*ROADMAP\.md §3 item 9.*quant_params_to_float"):
        quant_train.main(argv)
    assert not (tmp_path / "log.log").exists()


def test_float_model_trains(tmp_path):
    quant_train.main(_one_epoch(2) + ["--model", "deit_tiny_fp32", "--output-dir", str(tmp_path)])
    state, extra = load_checkpoint_raw(str(tmp_path / "checkpoint.pkl"))
    assert extra["model"] == "deit_tiny_fp32" and "softmax_bits" not in extra
    assert int(state["step"]) == 2 and flatten(state["quant_stats"]) == {}
    assert "blocks_0_attn_qkv" in state["params"] and len(_epoch0_losses(tmp_path)) == 2


def test_seq_parallel_without_a_model_axis_is_ignored(tmp_path, monkeypatch):
    """``--seq-parallel`` alone, in a world of one: ignored with JAX's
    warning, the run trains as without it."""
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    quant_train.main(_one_epoch(1) + ["--seq-parallel", "--output-dir", str(tmp_path)])
    log = (tmp_path / "log.log").read_text()
    assert "--seq-parallel ignored (needs --mesh-model > 1 and a ViT-family model)" in log
    assert "tensor parallelism" not in log and (tmp_path / "checkpoint.pkl").exists()


def test_fast_matmul_trains(tmp_path):
    """Two steps with ``--fast-matmul``: the first loss equals the float32
    run's (the forward is integer-exact either way); the switch is off
    again after the run."""
    quant_train.main(_one_epoch(2) + ["--fast-matmul", "--output-dir", str(tmp_path / "fast")])
    assert quant.SIM_FAST_MATMUL is False
    quant_train.main(_one_epoch(2) + ["--output-dir", str(tmp_path / "full")])
    fast, full = _epoch0_losses(tmp_path / "fast"), _epoch0_losses(tmp_path / "full")
    assert len(fast) == 2 and fast[0] == full[0]
