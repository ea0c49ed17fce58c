"""The port's QAT Swin gradients against JAX's on the CPU.

On the two tiny configurations of ``tests/test_torch_qat_swin.py``,
carried from flax: every parameter gradient of the soft-target loss in
train mode within 1e-5 of its leaf's largest entry (float32 sums in
other orders), as ``tests/test_torch_qat_model.py`` holds the ViT's.

JAX's gradient is taken eagerly, op by op, as its forward is: under
``jax.jit`` XLA contracts multiply-adds and turns divisions by constants
into reciprocal multiplies (``ROADMAP.md`` §3 item 6), and at config (a)
JAX's jitted gradient of ``layers_0_blocks_1.mlp.fc2.kernel`` then lies
2.3e-3 of the leaf's largest entry away from JAX's own eager one, where
the port's lies within 1e-6 of the eager one at both configurations.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ivit_tpu.train.losses import soft_target_cross_entropy as jax_soft_ce
from ivit_tpu_torch.train import soft_target_cross_entropy

from test_torch_qat_model import GRAD_RTOL, _flat
from test_torch_qat_swin import CONFIGS, _images, _pair, _targets
from tests.torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_parameter_gradients_match_jax(config):
    """Every parameter's gradient of the soft-target loss in train mode,
    each block's relative-position bias table among them (nonzero: the
    table reaches the scores through the straight-through quantizer)."""
    jm, v, tm = _pair(config)
    x, targets = _images(config, 3), _targets(3)

    def loss(params):
        logits, _ = jm.apply({"params": params, "quant_stats": v["quant_stats"]}, jnp.asarray(x), train=True,
                             mutable=["quant_stats"])
        return jax_soft_ce(logits, jnp.asarray(targets))

    jg = {k.replace("']['", ".").strip("[]'"): g for k, g in _flat(jax.grad(loss)(v["params"])).items()}
    names, params = zip(*tm.named_parameters())
    loss_t = soft_target_cross_entropy(tm(torch.from_numpy(x), train=True), torch.from_numpy(targets))
    grads = dict(zip(names, torch.autograd.grad(loss_t, params, materialize_grads=True)))
    assert set(names) == set(jg)
    for name, g in grads.items():
        ref = jg[name]
        np.testing.assert_allclose(g.numpy(), ref, rtol=0, atol=GRAD_RTOL * float(np.abs(ref).max()), err_msg=name)
    tables = [n for n in names if n.endswith("relative_position_bias_table")]
    assert len(tables) == sum(CONFIGS[config]["depths"])
    for name in tables:
        assert np.abs(jg[name]).max() > 0 and grads[name].abs().max() > 0, name
