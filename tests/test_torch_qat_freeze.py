"""The port's ``freeze_vit`` against JAX's, and the frozen model served.

On the tiny model of ``tests/test_torch_qat_model.py``, carried from
flax and moved by train-mode forwards on both sides (their ranges are
bit-equal there): the port's artifact equals JAX's ``freeze_vit`` array
for array and dtype for dtype, and the port's engine on it (``kernels=()``
and the kernel routes, whose wrappers run their plain versions on the
CPU) stays within JAX's own SIM↔DEPLOY bound of the port's SIM eval
forward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ivit_tpu.deploy import freeze_vit as jax_freeze_vit
from ivit_tpu_torch.deploy import build_vit_infer, freeze_vit, validate_artifact
from ivit_tpu_torch.models import create_model
from ivit_tpu_torch.models.model_utils import model_variables, scale_report
from ivit_tpu_torch.nn import flax_variables, load_flax_variables
from ivit_tpu_torch.train import AdamW, create_train_state

from test_torch_qat_model import CONFIGS, TINY, _flat, _images, _pair
from tests.torch_threads import one_torch_thread  # noqa: F401

ROUTE_A = ("layernorm", "attention2", "linear_gelu")


def _trained(softmax_bits=16, gelu_stable=False, steps=2, jax_too=True):
    """The pair of ``_pair`` after ``steps`` train-mode forwards on seeded
    images, JAX's side op by op, with its updated variables; without
    ``jax_too`` the port's model alone, from its own seeded init."""
    if jax_too:
        jm, v, tm = _pair(softmax_bits, gelu_stable)
    else:
        jm, v = None, None
        tm = create_model("deit_tiny", device="cpu", softmax_bits=softmax_bits, gelu_stable=gelu_stable, **TINY)
    for i in range(steps):
        x = _images(10 + i)
        if jax_too:
            _, upd = jm.apply(v, jnp.asarray(x), train=True, mutable=["quant_stats"])
            v = {"params": v["params"], "quant_stats": jax.tree.map(np.asarray, upd["quant_stats"])}
        tm(torch.from_numpy(x), train=True)
    return jm, v, tm


def test_freeze_matches_jax():
    jm, v, tm = _trained()
    ours = freeze_vit(tm, device="cpu")
    # op by op: under jit XLA turns the weight scale's division by the
    # constant 127 into a multiply by its reciprocal, which rounds 3% of
    # them an ulp away from the division JAX's simulator and the port run
    with jax.disable_jit():
        theirs = jax_freeze_vit(jm, v)
    validate_artifact(ours)
    assert ours["config"] == theirs["config"]

    def walk(a, b, path):
        if isinstance(b, dict):
            assert set(a) == set(b), path
            for k in b:
                walk(a[k], b[k], f"{path}.{k}")
        elif isinstance(b, list):
            assert len(a) == len(b), path
            for i, (x, y) in enumerate(zip(a, b)):
                walk(x, y, f"{path}[{i}]")
        else:
            x, y = np.asarray(a), np.asarray(b)
            assert (x.dtype, x.shape) == (y.dtype, y.shape), path
            np.testing.assert_array_equal(x, y, err_msg=path)

    walk({k: a for k, a in ours.items() if k != "config"}, {k: a for k, a in theirs.items() if k != "config"}, "")


@pytest.mark.parametrize("config,kernels", [("sm16-rowmax", ()), ("sm16-rowmax", ROUTE_A),
                                            ("sm8-stable", ()), ("sm8-stable", ("attention", "layernorm"))])
def test_sim_eval_matches_its_engine(config, kernels):
    """The port's frozen model served by the port's engine on the CPU
    (the kernels' plain versions) against the port's SIM eval forward,
    within JAX's own bound (``tests/test_deploy.py``: three steps of the
    head's output scale, argmax equal)."""
    _, _, tm = _trained(*CONFIGS[config], jax_too=False)
    art = freeze_vit(tm, device="cpu")
    x = torch.from_numpy(_images(42, 8))
    sim = tm(x, train=False).detach()
    served = build_vit_infer(art, "cpu", kernels=kernels)(x)
    head = float(np.max(art["head"]["out_scale"]))
    np.testing.assert_allclose(served.numpy(), sim.numpy(), atol=3 * head, rtol=0)
    np.testing.assert_array_equal(served.argmax(-1).numpy(), sim.argmax(-1).numpy())


def test_flax_variables_round_trip():
    _, v, tm = _pair(16, False)
    back = flax_variables(load_flax_variables(tm, v))
    theirs, ours = _flat(v), _flat(back)
    assert ours.keys() == theirs.keys()
    for name, a in theirs.items():
        assert (ours[name].dtype, ours[name].shape) == (a.dtype, a.shape), name
        np.testing.assert_array_equal(ours[name], a, err_msg=name)
    with pytest.raises(KeyError):
        load_flax_variables(tm, {"params": {}, "quant_stats": v["quant_stats"]})


def test_scale_report_and_entry_points():
    """Every QuantAct's range and scale, in flax's module paths; the
    entry points default to the card and raise without one; a Swin name
    builds the QAT Swin."""
    _, v, tm = _trained(steps=1)
    report = scale_report(model_variables(tm))
    assert len(report) == 5 + 11 * TINY["depth"] and "blocks_1/attn/qact_attn1" in report
    mn, mx, s = report["qact_input"]
    assert mn == float(v["quant_stats"]["qact_input"]["min_val"]) and s > 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            create_model("deit_tiny", **TINY)
        with pytest.raises(RuntimeError):
            freeze_vit(tm)
        with pytest.raises(RuntimeError):
            create_train_state(tm, AdamW(1e-3))
    swin = create_model("swin_tiny", device="cpu")
    assert type(swin).__name__ == "SwinTransformer" and swin.config["depths"] == (2, 2, 6, 2)
