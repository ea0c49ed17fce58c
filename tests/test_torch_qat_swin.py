"""The port's QAT Swin forward and mixup/cutmix against JAX's on the CPU.

Two tiny configurations, each initialized by flax and carried into the
port by ``load_flax_variables``:

* (a) JAX's own ``trained_tiny_swin`` (``tests/test_swin_deploy.py``):
  img 16, patch 2, embed 16, depths (2, 2), heads (2, 4), window 4 — a
  shifted block, a patch merging, and a pool over L = 16 tokens;
* (b) img 28, patch 2, window 7: grid 14 with shift 3, then a 7 × 7 last
  stage whose window is clamped and unshifted, and a pool over L = 49.

JAX runs eagerly, every op its own dispatch (so no multiply-add is
contracted and no division by a constant becomes a reciprocal multiply,
``ROADMAP.md`` §3 item 6). ``jnp.mean`` is itself a jitted function, so
even there its pool is the exact sum times float32(1/L), the value of
JAX's jitted trainer, eval step and engine, which the port follows
(``models.swin.token_mean``); only under ``jax.disable_jit()`` is it the
correctly rounded quotient, which differs at L = 49 and not at a power of
two (``test_pool_rounds_as_jitted_jax``). Against that run the forward
is held bit-equal (tolerance 0): train-mode logits and every
``quant_stats`` leaf over two steps (the first assigns the ranges, the
second moves them), and eval logits; the loss within 2 ulps, as
``tests/test_torch_qat_model.py`` holds the ViT's and for its reason.
The gradients are ``tests/test_torch_qat_swin_grad.py``'s, freezing,
serving and the entry points ``tests/test_torch_qat_swin_freeze.py``'s,
mixup/cutmix ``tests/test_torch_augment.py``'s (one file each, so that
each stays near a minute on the CPU).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ivit_tpu.models import SwinTransformer as JaxSwin
from ivit_tpu.train.losses import soft_target_cross_entropy as jax_soft_ce
from ivit_tpu_torch.models import create_model
from ivit_tpu_torch.models.swin import token_mean
from ivit_tpu_torch.nn import flax_variables, load_flax_variables
from ivit_tpu_torch.train import soft_target_cross_entropy

from test_torch_qat_model import LOSS_ULPS, _flat
from tests.torch_threads import one_torch_thread  # noqa: F401

CONFIGS = {
    "a": dict(img_size=16, patch_size=2, num_classes=8, embed_dim=16, depths=(2, 2), num_heads=(2, 4), window_size=4),
    "b": dict(img_size=28, patch_size=2, num_classes=8, embed_dim=16, depths=(2, 2), num_heads=(2, 4), window_size=7),
}
BATCH = 2


def _images(config, seed, n=BATCH):
    img = CONFIGS[config]["img_size"]
    return np.random.default_rng(seed).standard_normal((n, img, img, 3)).astype(np.float32)


def _targets(seed, n=BATCH, classes=8):
    t = np.full((n, classes), 0.1 / classes, np.float32)
    t[np.arange(n), np.random.default_rng(seed).integers(0, classes, n)] += 0.9
    return t


@functools.lru_cache(maxsize=None)
def _init(config, gelu_stable, ape):
    """The flax model (drop-path 0) and its init variables as numpy."""
    jm = JaxSwin(**CONFIGS[config], drop_path_rate=0.0, gelu_stable=gelu_stable, ape=ape)
    v = jax.jit(lambda x: jm.init(jax.random.PRNGKey(1), x, train=False))(jnp.asarray(_images(config, 0)))
    return jm, jax.tree.map(np.asarray, v)


def _pair(config, gelu_stable=False, ape=False):
    """The flax model, its init variables, and the port's model on them."""
    jm, v = _init(config, gelu_stable, ape)
    tm = create_model("swin_tiny", device="cpu", drop_path_rate=0.0, gelu_stable=gelu_stable, ape=ape,
                      **CONFIGS[config])
    return jm, v, load_flax_variables(tm, v)


@pytest.mark.parametrize("ape", [False, True], ids=["no-ape", "ape"])
@pytest.mark.parametrize("gelu_stable", [False, True], ids=["rowmax", "stable"])
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_train_and_eval_forward_match_jax(config, gelu_stable, ape):
    jm, v, tm = _pair(config, gelu_stable, ape)
    for step in range(2):
        x, targets = _images(config, 10 + step), _targets(step)
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
    x = _images(config, 42)
    np.testing.assert_array_equal(tm(torch.from_numpy(x), train=False).detach().numpy(),
                                  np.asarray(jm.apply(v, jnp.asarray(x), train=False)))


def test_pool_rounds_as_jitted_jax():
    """``token_mean`` equals JAX's ``jnp.mean`` eager and under ``jit``
    (the exact sum times float32(1/L)) on the SIM carrier and the
    engine's int16 stream, where ``jax.disable_jit()`` gives the
    correctly rounded quotient: at L = 49 the two differ, at 16 not."""
    for L in (16, 49):
        y = np.random.default_rng(L).integers(-128, 128, (512, L, 8)).astype(np.float32)
        ours = token_mean(torch.from_numpy(y)).numpy()
        np.testing.assert_array_equal(token_mean(torch.from_numpy(y).to(torch.int16)).numpy(), ours)
        np.testing.assert_array_equal(ours, np.asarray(jnp.mean(jnp.asarray(y), axis=1)))
        np.testing.assert_array_equal(ours, np.asarray(jax.jit(lambda a: jnp.mean(a, axis=1))(y)))
        with jax.disable_jit():
            quotient = np.asarray(jnp.mean(jnp.asarray(y), axis=1))
        np.testing.assert_array_equal(quotient, (y.astype(np.float64).sum(1) / L).astype(np.float32))
        assert (quotient != ours).any() == (L == 49)
