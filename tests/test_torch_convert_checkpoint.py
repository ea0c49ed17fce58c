"""``python -m ivit_tpu_torch.convert_model --checkpoint`` against the JAX
package's ``convert_model.main`` on the same checkpoint, array for array
and dtype for dtype, and its spec resolution (the conflict cases of
``tests/test_convert_meta.py``).

The checkpoints are the port's (``utils.checkpoint``, JAX's format, which
``tests/test_torch_checkpoint.py`` holds to JAX's both ways), of a
full-width ``deit_tiny`` at 32² and a full-width ``swin_tiny`` at 32²
with window 2 (stage resolutions 8, 4, 2, 1: the smallest input JAX's
converter builds Swin-T at), their ranges set by two train-mode
forwards. JAX's converter runs op by op (``jax.disable_jit()``): under
jit XLA turns the weight scale's division by 127 into a multiply by its
reciprocal, as ``tests/test_torch_qat_freeze.py`` says.
"""

import pickle

import jax
import numpy as np
import pytest
import torch

import convert_model as jax_convert_model
from ivit_tpu_torch import convert_model
from ivit_tpu_torch.models import create_model
from ivit_tpu_torch.train import AdamW, create_train_state
from ivit_tpu_torch.utils import save_checkpoint
from tests.torch_threads import one_torch_thread  # noqa: F401

META = {"model": "deit_tiny", "input_size": 32, "nb_classes": 10, "softmax_bits": 8, "gelu_stable": True}
SWIN_META = {"model": "swin_tiny", "input_size": 32, "nb_classes": 10, "softmax_bits": 8, "gelu_stable": False,
             "window_size": 2}


def _checkpoint(tmp_path, meta, name="ckpt.pkl"):
    kw = dict(num_classes=meta["nb_classes"], img_size=meta["input_size"])
    if meta["model"].startswith("swin"):
        kw["window_size"] = meta["window_size"]
    elif meta["softmax_bits"] != 16:
        kw["softmax_bits"] = meta["softmax_bits"]
    if meta["gelu_stable"]:
        kw["gelu_stable"] = True
    model = create_model(meta["model"], "cpu", seed=3, **kw)
    rng = np.random.default_rng(4)
    with torch.no_grad():
        for _ in range(2):
            model(torch.from_numpy(rng.standard_normal((2, 32, 32, 3)).astype(np.float32)), train=True)
    path = str(tmp_path / name)
    save_checkpoint(path, create_train_state(model, AdamW(1e-3), device="cpu"), dict(meta, epoch=4, best_acc1=1.5))
    return path


def _walk(a, b, path=""):
    if isinstance(b, dict):
        assert set(a) == set(b), path
        for k in b:
            _walk(a[k], b[k], f"{path}.{k}")
    elif isinstance(b, (list, tuple)):
        assert len(a) == len(b), path
        for i, (u, v) in enumerate(zip(a, b)):
            _walk(u, v, f"{path}[{i}]")
    elif isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b and type(a) is type(b), path


@pytest.mark.parametrize("meta", [META, SWIN_META], ids=["deit_tiny", "swin_tiny"])
def test_convert_checkpoint_equals_jax(meta, tmp_path, monkeypatch, capsys):
    """No spec flag: model, precision, GELU form and geometry all come
    from the checkpoint's record, on both sides."""
    monkeypatch.setenv("IVIT_XLA_CACHE", "off")
    ckpt = _checkpoint(tmp_path, meta)
    ours, theirs = str(tmp_path / "ours.pkl"), str(tmp_path / "theirs.pkl")
    convert_model.main(["--checkpoint", ckpt, "--output", ours, "--device", "cpu"])
    assert f"wrote {ours} (epoch 4, best_acc1 1.5)" in capsys.readouterr().out
    with jax.disable_jit():
        jax_convert_model.main(["--checkpoint", ckpt, "--output", theirs])
    with open(ours, "rb") as f, open(theirs, "rb") as g:
        a, b = pickle.load(f), pickle.load(g)
    assert a["config"]["img_size"] == 32 and a["config"]["num_classes"] == 10
    _walk(a, b)


def _fake_checkpoint(tmp_path, extra):
    """The conflict checks fire before the model is built, so the state is
    never read."""
    path = str(tmp_path / "fake.pkl")
    with open(path, "wb") as f:
        pickle.dump({"state": {"params": {}, "quant_stats": {}}, "extra": extra}, f, protocol=4)
    return path


SWIN_FAKE = {"model": "swin_tiny", "window_size": 4, "input_size": 32, "nb_classes": 10}


@pytest.mark.parametrize("extra,argv,match", [
    (META, ["--model", "deit_small"], "deit_tiny"),
    (META, ["--softmax-bits", "16"], "softmax-bits"),
    (META, ["--input-size", "224"], "input-size"),
    (META, ["--nb-classes", "100"], "nb-classes"),
    (SWIN_FAKE, ["--window-size", "7"], "window-size"),
], ids=["model", "softmax-bits", "input-size", "nb-classes", "window-size"])
def test_conflicting_flag_exits_like_jax(extra, argv, match, tmp_path, monkeypatch):
    """The port exits with the JAX CLI's message, before building anything."""
    monkeypatch.setenv("IVIT_XLA_CACHE", "off")
    ckpt = _fake_checkpoint(tmp_path, extra)
    with pytest.raises(SystemExit, match=match) as ours:
        convert_model.main(["--checkpoint", ckpt] + argv)
    with pytest.raises(SystemExit) as theirs:
        jax_convert_model.main(["--checkpoint", ckpt] + argv)
    assert str(ours.value.code) == str(theirs.value.code)


@pytest.mark.parametrize("extra,argv", [
    (dict(SWIN_FAKE, softmax_bits=16), ["--softmax-bits", "8", "--window-size", "4"]),
    (META, ["--model", "deit_tiny", "--input-size", "32", "--nb-classes", "10", "--softmax-bits", "8",
            "--gelu-stable"]),
    ({"epoch": 3}, ["--model", "deit_tiny", "--input-size", "32", "--nb-classes", "10"]),
], ids=["legacy-swin-softmax16", "matching-flags", "pre-metadata"])
def test_agreeing_flags_pass_resolution(extra, argv, tmp_path):
    """Past the spec checks (the Swin's legacy softmax-16 record, flags
    equal to the record, a checkpoint without one), the fake state fails
    where the weights load: the resolution let it through."""
    ckpt = _fake_checkpoint(tmp_path, extra)
    with pytest.raises(KeyError, match="params"):
        convert_model.main(["--checkpoint", ckpt, "--device", "cpu"] + argv)
