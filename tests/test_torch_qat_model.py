"""The port's QAT ViT against JAX's on the CPU, on the same variables.

A tiny model (img 16, patch 8, embed 32, depth 2, heads 4, 8 classes, as
``tests/test_deploy.py``) is initialized by flax and carried into the
port by ``load_flax_variables``. Forward values are held bit-equal
(tolerance 0) to JAX's ``apply`` run op by op: train-mode logits and
every updated ``quant_stats`` leaf over two steps (the first assigns the
ranges, the second moves them by the EMA), and eval-mode logits; under
``jax.jit`` XLA's CPU compiler contracts ``x.q·s + id.q·s_id`` and the
EMA ``m·min + (1−m)·cur`` into fused multiply-adds, so the ranges there
move by an ulp and this comparison stays with the unfused ops. The loss is held within
2 ulps (the port's is float64 rounded once; JAX's float32 log-softmax
rounds in its own order). Parameter gradients (JAX's jitted
``value_and_grad``) are held within 1e-5 of each leaf's largest entry:
float32 sums in other orders. Freezing is ``tests/test_torch_qat_freeze.py``'s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ivit_tpu.models import VisionTransformer as JaxViT
from ivit_tpu.train.losses import soft_target_cross_entropy as jax_soft_ce
from ivit_tpu_torch.models import create_model
from ivit_tpu_torch.nn import flax_variables, load_flax_variables
from ivit_tpu_torch.train import soft_target_cross_entropy
from tests.torch_threads import one_torch_thread  # noqa: F401

TINY = dict(img_size=16, patch_size=8, num_classes=8, embed_dim=32, depth=2, num_heads=4)
CONFIGS = {"sm16-rowmax": (16, False), "sm8-rowmax": (8, False), "sm8-stable": (8, True)}
GRAD_RTOL = 1e-5
# the port's loss is float64 rounded once to float32 (the same on the CPU
# and the card); JAX's float32 log-softmax and sums round on their own
LOSS_ULPS = 2


def _images(seed, n=4):
    return np.random.default_rng(seed).standard_normal((n, 16, 16, 3)).astype(np.float32)


def _pair(softmax_bits, gelu_stable):
    """The flax model with its init variables, and the port's model on them."""
    jm = JaxViT(**TINY, softmax_bits=softmax_bits, gelu_stable=gelu_stable)
    v = jax.jit(lambda x: jm.init(jax.random.PRNGKey(1), x, train=False))(jnp.asarray(_images(0)))
    v = jax.tree.map(np.asarray, v)
    tm = create_model("deit_tiny", device="cpu", softmax_bits=softmax_bits, gelu_stable=gelu_stable, **TINY)
    return jm, v, load_flax_variables(tm, v)


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(a) for p, a in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_train_and_eval_forward_match_jax(config):
    jm, v, tm = _pair(*CONFIGS[config])
    targets = np.full((4, 8), 0.1 / 8, np.float32)
    targets[np.arange(4), [1, 5, 0, 7]] += 0.9
    for step in range(2):
        x = _images(10 + step)
        jl, upd = jm.apply(v, jnp.asarray(x), train=True, mutable=["quant_stats"])
        v = {"params": v["params"], "quant_stats": jax.tree.map(np.asarray, upd["quant_stats"])}
        tl = tm(torch.from_numpy(x), train=True)
        np.testing.assert_array_equal(tl.detach().numpy(), np.asarray(jl))
        ours, theirs = _flat(flax_variables(tm)["quant_stats"]), _flat(v["quant_stats"])
        assert ours.keys() == theirs.keys()
        for name in theirs:
            np.testing.assert_array_equal(ours[name], theirs[name], err_msg=f"step {step} {name}")
        loss = soft_target_cross_entropy(tl, torch.from_numpy(targets)).item()
        jax_loss = np.float32(jax_soft_ce(jl, jnp.asarray(targets)))
        assert abs(loss - jax_loss) <= LOSS_ULPS * np.spacing(jax_loss)
    x = _images(42)
    np.testing.assert_array_equal(tm(torch.from_numpy(x), train=False).detach().numpy(),
                                  np.asarray(jm.apply(v, jnp.asarray(x), train=False)))


def test_parameter_gradients_match_jax():
    """Every parameter's gradient of the soft-target loss in train mode,
    cls_token's among them: nonzero, because the cls rounding is
    straight through (``models/vit.py``)."""
    jm, v, tm = _pair(16, False)
    x = _images(3)
    targets = np.full((4, 8), 1 / 8, np.float32)

    def loss(params):
        logits, _ = jm.apply({"params": params, "quant_stats": v["quant_stats"]}, jnp.asarray(x), train=True,
                             mutable=["quant_stats"])
        return jax_soft_ce(logits, jnp.asarray(targets))

    jg = {k.replace("']['", ".").strip("[]'"): g for k, g in _flat(jax.jit(jax.grad(loss))(v["params"])).items()}
    names, params = zip(*tm.named_parameters())
    loss_t = soft_target_cross_entropy(tm(torch.from_numpy(x), train=True), torch.from_numpy(targets))
    grads = torch.autograd.grad(loss_t, params, materialize_grads=True)
    assert set(names) == set(jg)
    for name, g in zip(names, grads):
        ref = jg[name]
        np.testing.assert_allclose(g.numpy(), ref, rtol=0, atol=GRAD_RTOL * float(np.abs(ref).max()), err_msg=name)
    assert np.abs(jg["cls_token"]).max() > 0 and dict(zip(names, grads))["cls_token"].abs().max() > 0
