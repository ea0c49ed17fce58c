"""The port's trainer against JAX's on the CPU: schedule, losses, the
optimizer, train and eval steps, dropout and stochastic depth.

``AdamW.update`` alone is held bit-equal to ``optax.adamw`` run op by
op. The bounds below are only for the whole jitted train step.

Three train steps run on both sides from the same variables (carried
from flax, tiny model of ``tests/test_torch_qat_model.py``): JAX's
jitted ``make_train_step`` with ``optax.adamw`` on ``cosine_schedule``,
the port's ``make_train_step`` with its ``AdamW``. Under ``jax.jit``
XLA's CPU compiler fuses multiply-adds (``x.q·s + id.q·s_id``, the EMA
``m·min + (1−m)·cur``) and turns the scales' division by a constant
into a multiply by its reciprocal, so JAX's ranges and weight scales
move by an ulp against the ops as written, which the port runs; a
requant that flips on such an ulp changes a gradient from the second
step on. So: step 1's loss within 2 ulps (float32 log-softmax orders)
and its parameters within 1e-3·lr (Adam's first update is
``lr·g/(|g| + eps)``, which follows g's value only where |g| ≈ eps); after three steps parameters and their EMA within
0.5·lr; each also within two float32 ulps of its value (XLA fuses the
EMA's ``e·d + p·(1−d)``); every range within 8 ulps of JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ivit_tpu.nn import vit_blocks as jax_blocks
from ivit_tpu.core.qtensor import QTensor as JaxQTensor
from ivit_tpu.train import cosine_schedule as jax_cosine_schedule
from ivit_tpu.train import create_train_state as jax_create_train_state
from ivit_tpu.train import make_eval_step as jax_make_eval_step
from ivit_tpu.train import make_train_step as jax_make_train_step
from ivit_tpu.train.losses import cross_entropy as jax_cross_entropy
from ivit_tpu.train.losses import distillation_loss as jax_distillation_loss
from ivit_tpu.train.losses import soft_target_cross_entropy as jax_soft_ce
from ivit_tpu.train.losses import topk_accuracy as jax_topk_accuracy
from ivit_tpu_torch.core import QTensor
from ivit_tpu_torch.models.model_utils import eval_variables
from ivit_tpu_torch.nn import flax_variables, vit_blocks
from ivit_tpu_torch.train import (
    AdamW,
    cosine_schedule,
    create_train_state,
    cross_entropy,
    distillation_loss,
    make_eval_step,
    make_train_step,
    soft_target_cross_entropy,
    topk_accuracy,
)

from test_torch_qat_model import TINY, _flat, _images, _pair
from tests.torch_threads import one_torch_thread  # noqa: F401

LOSS_ULPS = 2
F32_ULPS2 = 2.0**-22  # two float32 ulps, relative: XLA fuses the EMA's e·d + p·(1−d)
LR, WD, EMA, CLIP = 1e-3, 0.05, 0.9, 1.0  # WD large enough to show at step 1


def _ulps(a, b):
    return float(np.max(np.abs(np.float32(a) - np.float32(b)) / np.spacing(np.abs(np.float32(b)))))


@pytest.mark.parametrize("args", [(1e-3, 2, 3, 1, 1e-6, None), (5e-4, 50, 90, 5, 1e-6, None),
                                  (1e-6, 100, 90, 0, 1e-6, 5e-7), (2e-3, 7, 11, 2, 1e-4, 1e-5)])
def test_cosine_schedule_matches_optax(args):
    """Every step of the schedule, and past its end, within 8 float32
    ulps: the cosine's float32 evaluation (XLA's against numpy's) near
    cos = −1, where 1 + cos cancels."""
    lr, spe, epochs, warm, warm_lr, min_lr = args
    ours = cosine_schedule(lr, spe, epochs, warmup_epochs=warm, warmup_lr=warm_lr, min_lr=min_lr)
    theirs = jax_cosine_schedule(lr, spe, epochs, warmup_epochs=warm, warmup_lr=warm_lr, min_lr=min_lr)
    counts = np.arange(spe * epochs + 5)
    ref = np.asarray(jax.vmap(theirs)(jnp.asarray(counts, jnp.int32)))
    got = np.array([ours(int(c)) for c in counts], np.float32)
    assert np.max(np.abs(got - ref) / np.spacing(ref)) <= 8


def test_losses_match_jax():
    """Within 2 ulps (float64 here, float32 sums there); top-k exact,
    ties broken as JAX's stable argsort breaks them."""
    rng = np.random.default_rng(5)
    logits = rng.normal(0, 3, (16, 10)).astype(np.float32)
    logits[0, :4] = 2.0  # a tie
    teacher = rng.normal(0, 3, (16, 10)).astype(np.float32)
    labels = rng.integers(0, 10, 16)
    targets = rng.dirichlet(np.ones(10), 16).astype(np.float32)
    t, tt = torch.from_numpy(logits), torch.from_numpy(teacher)
    jl, jt = jnp.asarray(logits), jnp.asarray(teacher)
    for smoothing in (0.0, 0.1):
        assert _ulps(cross_entropy(t, torch.from_numpy(labels), smoothing),
                     jax_cross_entropy(jl, jnp.asarray(labels), smoothing)) <= LOSS_ULPS
    base = soft_target_cross_entropy(t, torch.from_numpy(targets))
    jbase = jax_soft_ce(jl, jnp.asarray(targets))
    assert _ulps(base, jbase) <= LOSS_ULPS
    for kind in ("soft", "hard"):
        assert _ulps(distillation_loss(t, base, tt, kind, 0.3, 2.0),
                     jax_distillation_loss(jl, jbase, jt, kind, 0.3, 2.0)) <= 4 * LOSS_ULPS
    assert distillation_loss(t, base, None, "soft") is base
    for k in (1, 5):
        assert float(topk_accuracy(t, torch.from_numpy(labels), k)) == float(
            jax_topk_accuracy(jl, jnp.asarray(labels), k))


@pytest.mark.parametrize("b1,b2,wd", [(0.9, 0.999, 0.05), (0.8, 0.99, 1e-4)])
def test_adamw_update_matches_optax(b1, b2, wd):
    """``AdamW.update`` against ``optax.adamw`` on ``cosine_schedule``,
    both run op by op, on the same parameters (some zero) and five
    gradients whose entries span 1e-9 to 1 (so eps, both moments and
    their decays all show in the update): parameters and both moments
    bit-equal after every step."""
    rng = np.random.default_rng(3)
    shapes = [(7, 5), (13,), (3, 4, 2)]
    params = [rng.normal(0, 0.05, s).astype(np.float32) for s in shapes]
    params[1][:3] = 0.0
    sched = dict(base_lr=LR, steps_per_epoch=2, epochs=4, warmup_epochs=1, warmup_lr=LR / 2)
    tx = optax.adamw(jax_cosine_schedule(**sched), b1=b1, b2=b2, weight_decay=wd)
    jp = [jnp.asarray(a) for a in params]
    js = tx.init(jp)
    opt = AdamW(cosine_schedule(**sched), b1=b1, b2=b2, weight_decay=wd)
    tp = [torch.from_numpy(a.copy()) for a in params]
    ts = opt.init(tp)
    for step in range(5):
        grads = [(rng.normal(0, 1, s) * 10.0 ** rng.integers(-9, 1, s)).astype(np.float32) for s in shapes]
        upd, js = tx.update([jnp.asarray(g) for g in grads], js, jp)
        jp = optax.apply_updates(jp, upd)
        opt.update(tp, [torch.from_numpy(g) for g in grads], ts)
        adam = js[0]
        assert ts.count == int(adam.count) == step + 1
        for name, ours, theirs in (("param", tp, jp), ("mu", ts.mu, adam.mu), ("nu", ts.nu, adam.nu)):
            for i, (a, b) in enumerate(zip(ours, theirs)):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f"step {step} {name} {i}")


def _batches(n):
    rng = np.random.default_rng(21)
    for _ in range(n):
        x = rng.standard_normal((4, 16, 16, 3)).astype(np.float32)
        targets = np.full((4, 8), 0.1 / 8, np.float32)
        targets[np.arange(4), rng.integers(0, 8, 4)] += 0.9
        yield x, targets


def test_three_train_steps_match_jax():
    jm, v, tm = _pair(16, False)
    sched = dict(base_lr=LR, steps_per_epoch=2, epochs=3, warmup_epochs=1, warmup_lr=LR / 2)
    tx = optax.adamw(jax_cosine_schedule(**sched), weight_decay=WD)
    js = jax_create_train_state(jm, jax.random.PRNGKey(1), jnp.asarray(_images(0)), tx, ema_decay=EMA)
    js = js.replace(params=jax.tree.map(jnp.asarray, v["params"]),
                    ema_params=jax.tree.map(jnp.asarray, v["params"]), opt_state=tx.init(v["params"]))
    jstep = jax.jit(jax_make_train_step(jm, ema_decay=EMA, grad_clip=CLIP))
    ts = create_train_state(tm, AdamW(cosine_schedule(**sched), weight_decay=WD), ema_decay=EMA, device="cpu")
    assert all(not b.any() for b in tm.buffers())  # no range update at creation
    step = make_train_step(tm, ema_decay=EMA, grad_clip=CLIP)
    for i, (x, targets) in enumerate(_batches(3)):
        js, jmet = jstep(js, jnp.asarray(x), jnp.asarray(targets), jax.random.PRNGKey(i))
        ts, met = step(ts, torch.from_numpy(x), torch.from_numpy(targets))
        lr = cosine_schedule(**sched)(i)
        bound = 1e-3 * lr if i == 0 else 0.5 * LR
        theirs = _flat(jax.tree.map(np.asarray, {"params": js.params, "ema": js.ema_params}))
        ours = _flat({"params": flax_variables(tm)["params"],
                      "ema": {k: a.numpy() for k, a in ts.ema_params.items()}})
        ours = {k.replace(".", "']['"): a for k, a in ours.items()}
        assert ours.keys() == theirs.keys()
        for name, a in theirs.items():
            np.testing.assert_allclose(ours[name], a, rtol=F32_ULPS2, atol=bound, err_msg=f"step {i} {name}")
        if i == 0:
            assert _ulps(met["loss"], jmet["loss"]) <= LOSS_ULPS
            assert float(met["acc1"]) == float(jmet["acc1"])
    assert ts.step == 3 and int(js.step) == 3 and ts.opt_state.count == 3
    stats, jstats = _flat(flax_variables(tm)["quant_stats"]), _flat(jax.tree.map(np.asarray, js.quant_stats))
    for name, a in jstats.items():
        assert _ulps(stats[name], a) <= 8, name


def test_eval_step_matches_jax():
    """Frozen ranges on the EMA weights, logits bit-equal to JAX's eval
    step run op by op (under jit XLA's reciprocal scales move them);
    rows past ``n_valid`` count in no accuracy."""
    jm, _, tm = _pair(16, False)
    for x, _ in _batches(2):
        tm(torch.from_numpy(x), train=True)
    state = create_train_state(tm, AdamW(1e-3), ema_decay=0.5, device="cpu")
    v = flax_variables(tm)  # the EMA weights equal the live ones at creation
    with torch.no_grad():
        for p in tm.parameters():  # the live weights move off the EMA ones
            p.mul_(1.5)
    variables = eval_variables(state)
    x = _images(7, 6)
    labels = np.array([0, 3, 5, 7, 1, 1])
    step = make_eval_step(tm, return_logits=True)
    for n_valid in (6, 4):
        with jax.disable_jit():
            jmet, jlog = jax_make_eval_step(jm, return_logits=True)(v, jnp.asarray(x), jnp.asarray(labels), n_valid)
        met, logits = step(variables, torch.from_numpy(x), torch.from_numpy(labels), n_valid)
        np.testing.assert_array_equal(logits.numpy(), np.asarray(jlog))
        for k in ("acc1", "acc5"):
            assert float(met[k]) == pytest.approx(float(jmet[k]), rel=1e-6)
    live = make_eval_step(tm)(eval_variables(state, use_ema=False), torch.from_numpy(x), torch.from_numpy(labels), 6)
    assert live.keys() == {"acc1", "acc5"}


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_and_drop_path_match_jax(rate, monkeypatch):
    """The same 0/1 mask imposed on both sides: quant_dropout masks the
    carrier and folds 1/keep into the scale; drop_path scales the kept
    samples' carrier by 1/keep."""
    rng = np.random.default_rng(int(rate * 10))
    q = rng.integers(-128, 128, (4, 5, 8)).astype(np.float32)
    s = np.float32(0.021)
    masks = {}

    def fake_bernoulli(key, p, shape):
        masks[tuple(shape)] = rng.random(shape) < p
        return jnp.asarray(masks[tuple(shape)])

    monkeypatch.setattr(jax.random, "bernoulli", fake_bernoulli)
    monkeypatch.setattr(vit_blocks, "keep_mask",
                        lambda shape, keep, generator, device: torch.from_numpy(masks[tuple(shape)].astype(np.float32)))

    class _Rng:  # the flax module's make_rng
        def make_rng(self, name):
            return jax.random.PRNGKey(0)

    jd = jax_blocks.quant_dropout(_Rng(), JaxQTensor(q=jnp.asarray(q), scale=jnp.float32(s), bits=8), rate)
    d = vit_blocks.quant_dropout(QTensor(torch.from_numpy(q), torch.tensor(s), 8), rate)
    np.testing.assert_array_equal(d.q.numpy(), np.asarray(jd.q))
    assert float(d.scale) == float(jd.scale)
    jp = jax_blocks.drop_path(JaxQTensor(q=jnp.asarray(q), scale=jnp.float32(s), bits=8), rate, False,
                              jax.random.PRNGKey(1))
    p = vit_blocks.drop_path(QTensor(torch.from_numpy(q), torch.tensor(s), 8), rate)
    np.testing.assert_array_equal(p.q.numpy(), np.asarray(jp.q))
    assert vit_blocks.drop_path(QTensor(torch.from_numpy(q), torch.tensor(s), 8), 0.0).q is not None
