"""The port's data-parallel QAT step and ZeRO-1 (``ivit_tpu_torch.parallel``,
``train.make_train_step(..., mesh=)``) on two CPU ranks over ``gloo``.

One spawn of two ``torch_parallel_worker`` ranks runs three variants of
the tiny DeiT of ``tests/test_torch_qat_model.py`` (sm16, row-max GELU):

* data-parallel, two steps at a global batch of 8 with drop path 0.1
  and mixup/cutmix (applied to the global batch before the rows are
  split, as ``quant_train`` does), AdamW, the EMA and the clip;
* the same with ZeRO-1;
* ZeRO-1 from JAX's init variables, one step with drop path 0 and no
  mixup, against JAX's ``zero1_shardings`` step on a ``(2, 1)`` mesh.

The single-process step on the global batch runs in this process.
Every ``QuantAct`` range and every logit of the data-parallel step equal
it bit for bit: at the first step by design (the same parameters), and
here at the second too, because the first step's parameter difference
moved no weight's per-channel scale (at DeiT-S on the card it does,
``chip_smoke.py`` phase 12). The loss, the gradients and the parameters
agree to within float32 rounding only: the gradient is the mean of the
two shards' gradients (the all-reduce), summed in another order than
one backward over the whole batch sums it. ZeRO-1 equals the replicated
data-parallel step with tolerance 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ivit_tpu.models import VisionTransformer as JaxViT
from ivit_tpu.parallel import data_sharding as jax_data_sharding
from ivit_tpu.parallel import make_mesh as jax_make_mesh
from ivit_tpu.parallel import zero1_shardings as jax_zero1_shardings
from ivit_tpu.train import create_train_state as jax_create_train_state
from ivit_tpu.train import make_train_step as jax_make_train_step
from ivit_tpu_torch.models import create_model
from ivit_tpu_torch.parallel import Mesh, zero1_shardings
from ivit_tpu_torch.train import MixupConfig, mixup_cutmix
from ivit_tpu_torch.train.augment import one_hot_smooth

from torch_parallel_worker import as_numpy, run_ranks, train, train_variant
from tests.torch_threads import one_torch_thread  # noqa: F401

TINY = dict(img_size=16, patch_size=8, num_classes=8, embed_dim=32, depth=2, num_heads=4)
GLOBAL_BATCH = 8
LR = 1e-3
# the all-reduce's float32 order: each gradient leaf within this share of
# its largest entry, the loss within LOSS_ULPS, and the parameters after
# two Adam steps (each about lr·g/(|g| + eps)) within 1e-3·lr where the
# first gradient is at least 1e-2 of its leaf's largest entry; elsewhere
# g can lie near eps (1e-8), where its rounding moves the update itself,
# so only Adam's bound holds there: under 3·lr a step
GRAD_RTOL = 1e-5
LOSS_ULPS = 4
PARAM_ATOL = 1e-3 * LR
SMALL_GRAD = 1e-2
ADAM_ATOL = 2 * 3 * LR


def _batches(n, mixup):
    rng = np.random.default_rng(21)
    for i in range(n):
        x = torch.from_numpy(rng.standard_normal((GLOBAL_BATCH, 16, 16, 3)).astype(np.float32))
        labels = torch.from_numpy(rng.integers(0, 8, GLOBAL_BATCH))
        if mixup:
            x, t = mixup_cutmix(x, labels, MixupConfig(num_classes=8), np.random.default_rng((5, i)), device="cpu")
        else:
            t = one_hot_smooth(labels, 8, 0.1)
        yield x.numpy(), t.numpy(), 1000 + i


DP_SPEC = {"model": "deit_tiny", "model_kw": dict(TINY, drop_path_rate=0.1), "lr": LR, "wd": 0.05, "ema": 0.9,
           "clip": 1.0, "batches": list(_batches(2, mixup=True))}


def _jax_state():
    jm = JaxViT(**TINY)
    images = jnp.asarray(DP_SPEC["batches"][0][0])
    state = jax_create_train_state(jm, jax.random.PRNGKey(0), images[:1], optax.adamw(LR), ema_decay=0.99)
    return jm, state


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jm, jstate = _jax_state()
    variables = jax.tree.map(np.asarray, {"params": jstate.params, "quant_stats": jstate.quant_stats})
    jax_spec = {"model": "deit_tiny", "model_kw": dict(TINY), "variables": variables, "lr": LR, "wd": 1e-4,
                "ema": 0.99, "clip": None, "batches": list(_batches(1, mixup=False))}
    ranks = run_ranks(2, tmp_path_factory.mktemp("dp"), train, [(DP_SPEC, False), (DP_SPEC, True), (jax_spec, True)])
    return {"ranks": ranks, "single": train_variant(DP_SPEC, False, None), "jax": (jm, jstate, jax_spec)}


def _ulps(a, b):
    return abs(np.float32(a) - np.float32(b)) / np.spacing(np.abs(np.float32(b)))


def test_dp_ranges_and_logits_equal_the_single_process_step(runs):
    """Both steps: every rank holds every ``QuantAct`` range of the
    single-process step on the global batch, and the ranks' logits, in
    rank order, are its logits; tolerance 0."""
    single = runs["single"]
    for i, ref in enumerate(single["steps"]):
        logits = torch.cat([r[0]["steps"][i]["logits"] for r in runs["ranks"]])
        torch.testing.assert_close(logits, ref["logits"], rtol=0, atol=0, msg=f"step {i}")
        for rank, r in enumerate(runs["ranks"]):
            for name, b in ref["ranges"].items():
                assert torch.equal(r[0]["steps"][i]["ranges"][name], b), (i, rank, name)


def test_dp_loss_gradients_and_parameters_within_rounding(runs):
    """The averaged gradient of the first batch within GRAD_RTOL of each
    leaf's largest entry, the global loss within LOSS_ULPS and the
    accuracy equal, the parameters after two steps within PARAM_ATOL (or
    2^-22 relative) where the first gradient is not small and within
    ADAM_ATOL where it is, on every rank (the ranks agree exactly)."""
    single = runs["single"]
    r0 = runs["ranks"][0][0]
    for rank, r in enumerate(runs["ranks"]):
        for name, p in r[0]["params"].items():
            assert torch.equal(p, r0["params"][name]), (rank, name)
    for name, g in single["grads"].items():
        torch.testing.assert_close(r0["grads"][name], g, rtol=0, atol=GRAD_RTOL * float(g.abs().max()), msg=name)
    for i, ref in enumerate(single["steps"]):
        assert _ulps(r0["steps"][i]["loss"], ref["loss"]) <= LOSS_ULPS, i
        assert r0["steps"][i]["acc1"] == pytest.approx(ref["acc1"], abs=1e-4)
    for name, p in single["params"].items():
        g = single["grads"][name].abs()
        atol = torch.where(g >= SMALL_GRAD * g.max(), PARAM_ATOL, ADAM_ATOL)
        assert bool(((r0["params"][name] - p).abs() <= atol + 2.0**-22 * p.abs()).all()), name


def test_zero1_equals_dp(runs):
    """ZeRO-1 against the replicated data-parallel step from the same
    state: every range, logit, metric, parameter, EMA entry and moment
    (gathered whole) equal, tolerance 0, on every rank."""
    for rank, r in enumerate(runs["ranks"]):
        dp, z1 = r[0], r[1]
        for i, (a, b) in enumerate(zip(dp["steps"], z1["steps"])):
            assert torch.equal(a["logits"], b["logits"]) and a["loss"] == b["loss"] and a["acc1"] == b["acc1"]
            assert all(torch.equal(a["ranges"][n], b["ranges"][n]) for n in a["ranges"]), (rank, i)
        for key in ("params", "ema", "mu", "nu"):
            for name, t in dp[key].items():
                assert torch.equal(z1[key][name], t), (rank, key, name)


def _jax_key(name: str) -> str:
    return "['" + name.replace(".", "']['") + "']"


def test_zero1_slices_moments_on_jax_dimension(runs):
    """Each rank holds the moments of the dimension ``_add_axis`` picks,
    halved; the spec of each leaf equals JAX's ``zero1_shardings`` spec
    for the same leaf of ``opt_state`` and of ``ema_params`` on a
    ``(2, 1)`` mesh; leaves nothing divides stay whole."""
    _, jstate, _ = runs["jax"]
    sh = jax_zero1_shardings(jstate, jax_make_mesh(2, 1, devices=jax.devices()[:2]))
    ndim = {jax.tree_util.keystr(k): a.ndim for k, a in jax.tree_util.tree_leaves_with_path(jstate.params)}
    theirs = {}
    for tree in (sh.opt_state[0].mu, sh.ema_params):
        for path, s in jax.tree_util.tree_leaves_with_path(tree):
            key = jax.tree_util.keystr(path)
            theirs.setdefault(key, set()).add(tuple(s.spec) + (None,) * (ndim[key] - len(s.spec)))
    model = create_model("deit_tiny", device="cpu", **TINY)
    ours = zero1_shardings(model, Mesh(2, 1, 0, "cpu", {}))
    split = 0
    for name, p in model.named_parameters():
        spec = ours[name]
        assert theirs[_jax_key(name)] == {spec}, name
        local = runs["ranks"][0][1]["local_mu"][name]
        assert local == tuple(d // 2 if ax == "data" else d for d, ax in zip(p.shape, spec)), name
        split += "data" in spec
    assert split == len(ours)  # at this size every leaf has an even dimension


def test_zero1_step_matches_jax_zero1(runs):
    """The port's ZeRO-1 step on two ranks against JAX's jitted step
    with ``zero1_shardings`` on a ``(2, 1)`` mesh, from the same
    variables, one step with drop path 0 and no mixup: parameters and
    EMA within JAX's own bounds for its sharded step, rtol 1e-4 and atol
    2e-5 (``tests/test_zero1.py``)."""
    jm, jstate, spec = runs["jax"]
    mesh = jax_make_mesh(2, 1, devices=jax.devices()[:2])
    images, targets, _ = spec["batches"][0]
    step = jax.jit(jax_make_train_step(jm, ema_decay=0.99))
    js, _ = step(jax.device_put(jstate, jax_zero1_shardings(jstate, mesh)),
                 jax.device_put(jnp.asarray(images), jax_data_sharding(mesh)),
                 jax.device_put(jnp.asarray(targets), jax_data_sharding(mesh)), jax.random.PRNGKey(7))
    ours = runs["ranks"][0][2]
    for tree, key in ((js.params, "params"), (js.ema_params, "ema")):
        for path, a in jax.tree_util.tree_leaves_with_path(tree):
            name = jax.tree_util.keystr(path)[2:-2].replace("']['", ".")
            np.testing.assert_allclose(as_numpy(ours[key][name]), np.asarray(a), rtol=1e-4, atol=2e-5,
                                       err_msg=f"{key} {name}")
