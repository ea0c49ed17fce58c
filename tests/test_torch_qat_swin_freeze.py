"""The port's ``freeze_swin`` against JAX's, the frozen Swin served, and
the Swin entry points.

On the two tiny configurations of ``tests/test_torch_qat_swin.py``,
carried from flax and moved by two train-mode forwards of the port,
whose ranges that file holds bit-equal to JAX's; both freezes read the
same variables (``flax_variables`` carries the port's back to JAX).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ivit_tpu.deploy.swin_engine import build_swin_infer as jax_build_swin_infer
from ivit_tpu.deploy.swin_engine import freeze_swin as jax_freeze_swin
from ivit_tpu.models import SwinTransformer as JaxSwin
from ivit_tpu_torch.deploy import build_swin_infer, freeze_swin, validate_swin_artifact
from ivit_tpu_torch.models import create_config, create_model
from ivit_tpu_torch.nn import flax_variables
from ivit_tpu_torch.train import MixupConfig, mixup_cutmix

from test_torch_qat_swin import CONFIGS, _images, _pair
from tests.torch_threads import one_torch_thread  # noqa: F401


def _trained(config, steps=2):
    """``_pair``'s port model after ``steps`` train-mode forwards, with
    the flax model and the port's variables in flax's form."""
    jm, _, tm = _pair(config)
    for i in range(steps):
        tm(torch.from_numpy(_images(config, 10 + i)), train=True)
    return jm, flax_variables(tm), tm


def _walk(a, b, path):
    if isinstance(b, dict):
        assert set(a) == set(b), path
        for k in b:
            _walk(a[k], b[k], f"{path}.{k}")
    elif isinstance(b, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _walk(x, y, f"{path}[{i}]")
    elif b is None or isinstance(b, int):
        assert a == b and type(a) is type(b), path
    else:
        x, y = np.asarray(a), np.asarray(b)
        assert (x.dtype, x.shape) == (y.dtype, y.shape), path
        np.testing.assert_array_equal(x, y, err_msg=path)


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_freeze_and_engine_match_jax(config):
    """``freeze_swin`` equal to JAX's array for array and int for int
    (JAX's op by op: under jit its weight scale's division by 127 is a
    reciprocal multiply, as for ``freeze_vit``); the port's engine
    (``kernels=()``, and the K7 + K3 wrappers' plain versions) on it
    bit-equal to JAX's jitted ``build_swin_infer(use_pallas=False)`` on
    JAX's; and the port's SIM eval forward within 4 × the head's output
    scale of its own engine, argmax equal, as JAX's
    ``tests/test_swin_deploy.py`` holds JAX's (the engine pre-rounds the
    bias where SIM merges it in ``qact2``)."""
    jm, v, tm = _trained(config)
    ours = freeze_swin(tm, device="cpu")
    with jax.disable_jit():
        theirs = jax_freeze_swin(jm, v)
    validate_swin_artifact(ours)
    assert ours["config"] == theirs["config"]
    _walk({k: a for k, a in ours.items() if k != "config"}, {k: a for k, a in theirs.items() if k != "config"}, "")
    assert any(b["mask_int"] is not None for st in ours["stages"] for b in st["blocks"])

    x = _images(config, 42, 4)
    served = build_swin_infer(ours, "cpu", kernels=())(torch.from_numpy(x))
    np.testing.assert_array_equal(served.numpy(), np.asarray(jax.jit(jax_build_swin_infer(theirs, use_pallas=False))(x)))
    np.testing.assert_array_equal(build_swin_infer(ours, "cpu")(torch.from_numpy(x)).numpy(), served.numpy())
    sim = tm(torch.from_numpy(x), train=False).detach()
    head = float(np.max(ours["head"]["out_scale"]))
    np.testing.assert_allclose(served.numpy(), sim.numpy(), atol=4 * head, rtol=0)
    np.testing.assert_array_equal(served.argmax(-1).numpy(), sim.argmax(-1).numpy())


def test_entry_points():
    """``create_model("swin_tiny")``: JAX's parameter count and its
    drop-path default (0.1, rising linearly over the 12 blocks);
    ``remat=True`` builds (a float name with it raises); freezing an
    ``ape`` model raises; without a card the entry points raise instead
    of running on the CPU."""
    model = create_model("swin_tiny", device="cpu")
    shapes = jax.eval_shape(lambda: JaxSwin(**create_config("swin_tiny")).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3)), train=False))
    assert sum(p.numel() for p in model.parameters()) == sum(a.size for a in jax.tree.leaves(shapes["params"]))
    assert JaxSwin.drop_path_rate == 0.1 and model.config == create_config("swin_tiny")
    rates = [m.drop_path_rate for n, m in model.named_children() if "_blocks_" in n]
    np.testing.assert_array_equal(rates, np.linspace(0.0, 0.1, 12))
    assert create_model("swin_tiny", device="cpu", remat=True).remat is True
    with pytest.raises(ValueError, match="remat"):
        create_model("deit_small_fp32", device="cpu", remat=True)
    _, _, ape = _pair("a", ape=True)
    with pytest.raises(NotImplementedError):
        freeze_swin(ape, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            create_model("swin_tiny", **CONFIGS["a"])
        with pytest.raises(RuntimeError):
            freeze_swin(_pair("a")[2])
        with pytest.raises(RuntimeError):
            mixup_cutmix(torch.zeros(2, 4, 4, 3), torch.tensor([0, 1]), MixupConfig(num_classes=2),
                         np.random.default_rng(0))
