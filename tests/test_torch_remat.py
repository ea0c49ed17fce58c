"""Per-block recompute (``remat=True``) in the port's QAT models.

* Against the same model without it, on the CPU: a tiny DeiT (img 32,
  depth 2) and the two-stage Swin of ``tests/test_torch_qat_swin.py``,
  with drop-path, dropout and attention dropout at 0.1, the masks drawn
  from a seeded generator (or from the global one). Two train steps with
  an update between them, so that the second starts from moved ranges
  (on a fresh ``QuantAct`` a second update by the same batch moves
  nothing, ``0.95·r + 0.05·r = r``, so one step cannot show a doubled
  update). The logits, every ``min_val`` and ``max_val``, every gradient
  and the generator's final state are bit-equal (tolerance 0), and each
  recomputed block ran twice a step.
* Against JAX's ``remat=True`` models on the same variables (drop-path
  0: the two frameworks draw other masks): one train step's logits and
  ranges bit-equal to JAX's eager apply, the gradients within 1e-5 of
  each leaf's largest entry, as ``tests/test_torch_qat_model.py`` and
  ``tests/test_torch_qat_swin_grad.py`` hold them without recompute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ivit_tpu.models import SwinTransformer as JaxSwin
from ivit_tpu.models import VisionTransformer as JaxViT
from ivit_tpu.train.losses import soft_target_cross_entropy as jax_soft_ce
from ivit_tpu_torch.models import MODEL_REGISTRY, create_config, create_model
from ivit_tpu_torch.models.swin import SwinBlock
from ivit_tpu_torch.nn import Block, flax_variables, load_flax_variables
from ivit_tpu_torch.train import soft_target_cross_entropy

from test_torch_qat_model import GRAD_RTOL, _flat
from test_torch_qat_swin import CONFIGS as SWIN_CONFIGS
from tests.torch_threads import one_torch_thread  # noqa: F401

DEIT = dict(img_size=32, patch_size=8, num_classes=8, embed_dim=32, depth=2, num_heads=4)
MODELS = {"deit": ("deit_tiny", DEIT), "swin": ("swin_tiny", SWIN_CONFIGS["a"])}
DROPS = dict(drop_path_rate=0.1, drop_rate=0.1, attn_drop_rate=0.1)
BATCH = 4
LR = 0.05


def _batch(img, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((BATCH, img, img, 3)).astype(np.float32)
    t = np.full((BATCH, 8), 0.1 / 8, np.float32)
    t[np.arange(BATCH), rng.integers(0, 8, BATCH)] += 0.9
    return torch.from_numpy(x), torch.from_numpy(t)


def _train(model_key, remat, seeded):
    """Two train steps with a plain gradient step between; returns each
    step's logits, ranges and gradients, the generator's final state, and
    how often the blocks ran."""
    name, cfg = MODELS[model_key]
    model = create_model(name, device="cpu", seed=3, remat=remat, **DROPS, **cfg)
    blocks = [m for m in model.modules() if isinstance(m, (Block, SwinBlock))]
    calls = [0]
    for blk in blocks:
        blk.register_forward_pre_hook(lambda *_: calls.__setitem__(0, calls[0] + 1))
    gen = torch.Generator().manual_seed(11) if seeded else None
    torch.manual_seed(7)
    names, params = zip(*model.named_parameters())
    steps = []
    for step in range(2):
        x, t = _batch(cfg["img_size"], 20 + step)
        logits = model(x, train=True, generator=gen)
        grads = torch.autograd.grad(soft_target_cross_entropy(logits, t), params, materialize_grads=True)
        ranges = {n: b.clone() for n, b in model.named_buffers()}
        steps.append((logits.detach(), ranges, dict(zip(names, grads))))
        with torch.no_grad():
            for p, g in zip(params, grads):
                p.sub_(LR * g)
    final = (gen if seeded else torch.default_generator).get_state()
    return steps, final, calls[0], len(blocks)


@pytest.mark.parametrize("seeded", [True, False], ids=["generator", "global-rng"])
@pytest.mark.parametrize("model_key", sorted(MODELS))
def test_remat_equals_no_remat(model_key, seeded):
    plain, plain_state, plain_calls, n_blocks = _train(model_key, False, seeded)
    ours, our_state, our_calls, _ = _train(model_key, True, seeded)
    assert plain_calls == 2 * n_blocks and our_calls == 4 * n_blocks
    for step, ((lp, rp, gp), (lr, rr, gr)) in enumerate(zip(plain, ours)):
        torch.testing.assert_close(lr, lp, rtol=0, atol=0, msg=f"step {step} logits")
        assert rr.keys() == rp.keys() and len(rp) > 0
        for n in rp:
            torch.testing.assert_close(rr[n], rp[n], rtol=0, atol=0, msg=f"step {step} {n}")
        assert gr.keys() == gp.keys()
        for n in gp:
            torch.testing.assert_close(gr[n], gp[n], rtol=0, atol=0, msg=f"step {step} {n}")
    # the second step moved the ranges by the EMA: a doubled update would show
    assert any(not torch.equal(ours[1][1][n], ours[0][1][n]) for n in ours[0][1])
    assert torch.equal(our_state, plain_state)


def _jax_pair(model_key):
    name, cfg = MODELS[model_key]
    jax_cls = JaxViT if model_key == "deit" else JaxSwin
    jm = jax_cls(**cfg, drop_path_rate=0.0, remat=True)
    x0 = jnp.asarray(_batch(cfg["img_size"], 0)[0].numpy())
    v = jax.tree.map(np.asarray, jax.jit(lambda x: jm.init(jax.random.PRNGKey(1), x, train=False))(x0))
    tm = create_model(name, device="cpu", drop_path_rate=0.0, remat=True, **cfg)
    return jm, v, load_flax_variables(tm, v)


@pytest.mark.parametrize("model_key", sorted(MODELS))
def test_remat_matches_jax_remat(model_key):
    """One train step from the same variables: the forward and the moved
    ranges against JAX's eager ``apply``, the gradients against JAX's
    eager ``jax.grad`` (not jitted: under ``jax.jit`` XLA contracts
    multiply-adds, as ``tests/test_torch_qat_swin_grad.py`` sets out)."""
    jm, v, tm = _jax_pair(model_key)
    x, t = _batch(MODELS[model_key][1]["img_size"], 21)
    xj, tj = jnp.asarray(x.numpy()), jnp.asarray(t.numpy())
    jl, upd = jm.apply(v, xj, train=True, mutable=["quant_stats"])

    def loss(params):
        logits, _ = jm.apply({"params": params, "quant_stats": v["quant_stats"]}, xj, train=True,
                             mutable=["quant_stats"])
        return jax_soft_ce(logits, tj)

    jg = {k.replace("']['", ".").strip("[]'"): g for k, g in _flat(jax.grad(loss)(v["params"])).items()}
    names, params = zip(*tm.named_parameters())
    logits = tm(x, train=True)
    grads = torch.autograd.grad(soft_target_cross_entropy(logits, t), params, materialize_grads=True)

    np.testing.assert_array_equal(logits.detach().numpy(), np.asarray(jl))
    ours, theirs = _flat(flax_variables(tm)["quant_stats"]), _flat(upd["quant_stats"])
    assert ours.keys() == theirs.keys()
    for n in theirs:
        np.testing.assert_array_equal(ours[n], theirs[n], err_msg=n)
    assert set(names) == set(jg)
    for n, g in zip(names, grads):
        ref = jg[n]
        np.testing.assert_allclose(g.numpy(), ref, rtol=0, atol=GRAD_RTOL * float(np.abs(ref).max()), err_msg=n)


@pytest.mark.parametrize("name", sorted(MODEL_REGISTRY))
def test_create_model_takes_remat(name):
    """Every QAT name builds with ``remat=True`` (one block, or one
    stage of one block); a float name raises, as JAX's float models
    have no remat."""
    small = dict(depths=(1,), num_heads=(2,)) if "depths" in create_config(name) else dict(depth=1)
    assert create_model(name, device="cpu", remat=True, **small).remat is True
    with pytest.raises(ValueError, match="remat"):
        create_model(f"{name}_fp32", device="cpu", remat=True)
