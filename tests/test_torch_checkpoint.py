"""The port's optimizers and checkpoints against JAX's on the CPU,
tolerance 0.

* ``SGD`` against ``optax.chain(add_decayed_weights, sgd(momentum))`` on
  the cosine schedule, run op by op: parameters and trace bit-equal after
  each of five steps.
* Checkpoints both ways, for a tiny DeiT train state with AdamW and an
  EMA and with SGD: every leaf of JAX's state (parameters, ranges,
  moments or trace, counts, step, EMA) set to its own seeded values,
  saved by JAX's ``save_checkpoint`` and loaded by the port's
  ``load_checkpoint``, array for array; then saved by the port and
  loaded by JAX's ``load_checkpoint(path, target)``.
* A port checkpoint round trip: N steps, save, load into a fresh state
  and one more step equal N + 1 steps.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ivit_tpu.models import VisionTransformer as JaxViT
from ivit_tpu.train import cosine_schedule as jax_cosine_schedule
from ivit_tpu.train import create_train_state as jax_create_train_state
from ivit_tpu.utils import load_checkpoint as jax_load_checkpoint
from ivit_tpu.utils import save_checkpoint as jax_save_checkpoint
from ivit_tpu_torch.models import create_model
from ivit_tpu_torch.nn.flax_state import flatten
from ivit_tpu_torch.train import SGD, AdamW, cosine_schedule, create_train_state, make_train_step
from ivit_tpu_torch.utils import load_checkpoint, load_checkpoint_raw, save_checkpoint
from tests.torch_threads import one_torch_thread  # noqa: F401

TINY = dict(img_size=16, patch_size=8, num_classes=8, embed_dim=32, depth=2, num_heads=4)
SCHED = dict(base_lr=1e-3, steps_per_epoch=2, epochs=4, warmup_epochs=1, warmup_lr=5e-4)
WD, MOMENTUM, EMA = 0.05, 0.9, 0.9


def _optax(opt):
    sched = jax_cosine_schedule(**SCHED)
    if opt == "adamw":
        return optax.adamw(sched, weight_decay=WD)
    return optax.chain(optax.add_decayed_weights(WD), optax.sgd(sched, momentum=MOMENTUM))


def _ours(opt):
    sched = cosine_schedule(**SCHED)
    return AdamW(sched, weight_decay=WD) if opt == "adamw" else SGD(sched, momentum=MOMENTUM, weight_decay=WD)


def test_sgd_update_matches_optax():
    rng = np.random.default_rng(4)
    shapes = [(7, 5), (13,), (3, 4, 2)]
    params = [rng.normal(0, 0.05, s).astype(np.float32) for s in shapes]
    params[1][:3] = 0.0
    tx = _optax("sgd")
    jp = [jnp.asarray(a) for a in params]
    js = tx.init(jp)
    opt = _ours("sgd")
    tp = [torch.from_numpy(a.copy()) for a in params]
    ts = opt.init(tp)
    for step in range(5):
        grads = [(rng.normal(0, 1, s) * 10.0 ** rng.integers(-9, 1, s)).astype(np.float32) for s in shapes]
        upd, js = tx.update([jnp.asarray(g) for g in grads], js, jp)
        jp = optax.apply_updates(jp, upd)
        opt.update(tp, [torch.from_numpy(g) for g in grads], ts)
        trace, sched = js[1]
        assert ts.count == int(sched.count) == step + 1
        for name, ours, theirs in (("param", tp, jp), ("trace", ts.trace, trace.trace)):
            for i, (a, b) in enumerate(zip(ours, theirs)):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f"step {step} {name} {i}")


def _jax_state(opt, ema):
    model = JaxViT(**TINY)
    return jax_create_train_state(model, jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)), _optax(opt),
                                  ema_decay=EMA if ema else 0.0)


def _seeded(state, seed):
    """Every leaf of ``state`` replaced by seeded values of its shape and
    dtype; the optimizer's counts (which optax keeps equal) by 9, the
    step by 7."""
    rng = np.random.default_rng(seed)

    def fill(path, a):
        a = np.asarray(a)
        if a.dtype == np.int32:
            return jnp.asarray(7 if jax.tree_util.keystr(path) == ".step" else 9, jnp.int32)
        return jnp.asarray(rng.standard_normal(a.shape).astype(a.dtype))

    return jax.tree_util.tree_map_with_path(fill, state)


def _port_state(opt, ema):
    model = create_model("deit_tiny", "cpu", **TINY)
    return create_train_state(model, _ours(opt), ema_decay=EMA if ema else 0.0, device="cpu")


def _port_leaves(state):
    """The port's state as JAX's flattened leaf paths → arrays."""
    from ivit_tpu_torch.utils.checkpoint import train_state_dict

    return {k: np.asarray(v) for k, v in flatten(train_state_dict(state)).items() if v is not None}


def _jax_leaves(state):
    from flax import serialization

    sd = serialization.to_state_dict(jax.tree.map(np.asarray, state))
    return {k: np.asarray(v) for k, v in flatten(sd).items() if v is not None}


@pytest.mark.parametrize("opt,ema", [("adamw", True), ("sgd", False)], ids=["adamw-ema", "sgd"])
def test_jax_checkpoint_loads_into_the_port(opt, ema, tmp_path):
    js = _seeded(_jax_state(opt, ema), 1)
    path = str(tmp_path / "ckpt.pkl")
    jax_save_checkpoint(path, js, {"epoch": 3, "best_acc1": 12.5, "model": "deit_tiny"})
    ts, extra = load_checkpoint(path, _port_state(opt, ema))
    assert extra == {"epoch": 3, "best_acc1": 12.5, "model": "deit_tiny"}
    theirs, ours = _jax_leaves(js), _port_leaves(ts)
    assert ours.keys() == theirs.keys() and len(ours) > 100
    for name, a in theirs.items():
        assert ours[name].dtype == a.dtype, name
        np.testing.assert_array_equal(ours[name], a, err_msg=name)
    assert ts.step == int(js.step) == 7 and ts.opt_state.count == 9


@pytest.mark.parametrize("opt,ema", [("adamw", True), ("sgd", False)], ids=["adamw-ema", "sgd"])
def test_port_checkpoint_loads_into_jax(opt, ema, tmp_path):
    """The port's state after two train steps (moments, trace and EMA
    away from their initial values), read by JAX's ``load_checkpoint``
    into its own train state."""
    ts = _port_state(opt, ema)
    step = make_train_step(ts.model, ema_decay=EMA if ema else 0.0)
    rng = np.random.default_rng(2)
    for _ in range(2):
        x = torch.from_numpy(rng.standard_normal((4, 16, 16, 3)).astype(np.float32))
        step(ts, x, torch.full((4, 8), 1 / 8))
    path = str(tmp_path / "ckpt.pkl")
    save_checkpoint(path, ts, {"epoch": 0, "softmax_bits": 16})
    js, extra = jax_load_checkpoint(path, _jax_state(opt, ema))
    assert extra == {"epoch": 0, "softmax_bits": 16}
    theirs, ours = _jax_leaves(js), _port_leaves(ts)
    assert ours.keys() == theirs.keys()
    for name, a in ours.items():
        np.testing.assert_array_equal(theirs[name], a, err_msg=name)
    assert int(js.step) == ts.step == 2
    assert not any(isinstance(v, torch.Tensor) for v in flatten(load_checkpoint_raw(path)[0]).values())


@pytest.mark.parametrize("opt", ["adamw", "sgd"])
def test_resumed_step_equals_uninterrupted(opt, tmp_path):
    """Two steps, save, load into a fresh state, a third step: equal to
    three uninterrupted steps (parameters, ranges, optimizer state, EMA)."""
    rng = np.random.default_rng(5)
    batches = [(torch.from_numpy(rng.standard_normal((4, 16, 16, 3)).astype(np.float32)),
                torch.from_numpy(rng.dirichlet(np.ones(8), 4).astype(np.float32))) for _ in range(3)]
    a = _port_state(opt, True)
    step_a = make_train_step(a.model, ema_decay=EMA)
    for x, t in batches:
        step_a(a, x, t)
    b = _port_state(opt, True)
    step_b = make_train_step(b.model, ema_decay=EMA)
    for x, t in batches[:2]:
        step_b(b, x, t)
    save_checkpoint(str(tmp_path / "c.pkl"), b)
    c, _ = load_checkpoint(str(tmp_path / "c.pkl"), _port_state(opt, True))
    make_train_step(c.model, ema_decay=EMA)(c, *batches[2])
    ours, theirs = _port_leaves(c), _port_leaves(a)
    assert ours.keys() == theirs.keys()
    for name, v in theirs.items():
        np.testing.assert_array_equal(ours[name], v, err_msg=name)


def test_checkpoint_mismatches_and_urls_raise(tmp_path):
    path = str(tmp_path / "ckpt.pkl")
    save_checkpoint(path, _port_state("adamw", True))
    assert not (tmp_path / "ckpt.pkl.tmp").exists()
    with pytest.raises(ValueError, match="EMA"):
        load_checkpoint(path, _port_state("adamw", False))
    with pytest.raises(KeyError):
        load_checkpoint(path, _port_state("sgd", True))
    with open(path, "rb") as f:
        payload = pickle.load(f)
    del payload["state"]["params"]["head"]
    with open(path, "wb") as f:
        pickle.dump(payload, f)
    with pytest.raises(KeyError, match="head"):
        load_checkpoint(path, _port_state("adamw", True))
    with pytest.raises(ValueError, match="only local paths"):
        load_checkpoint_raw("https://example.invalid/ckpt.pkl")
