"""The port's float models against JAX's on the CPU, on the same weights.

The weights are a seeded state dict in the published layouts
(``tests/test_import.py:fake_torch_sd``, ``tests/test_import_swin.py:
fake_swin_sd``, scaled by 0.2 as JAX's golden tests scale them, for
well-conditioned activations), imported by the library path:
``torch_vit_to_params`` → ``quant_params_to_float`` → ``merge_params``
into JAX's init, then carried into the port by ``load_flax_variables``.
JAX runs under ``jax.jit``. The smallest configurations that reach every
branch: ViT D 32, depth 2, image 16, patch 8; Swin D 16, depths (2, 2),
window 4, image 32, patch 2 (a shifted block and a patch merging in
stage 0, a shifted block in stage 1).

The logits agree to FLOAT_TOL, not bit for bit: XLA and ATen sum the
float32 matmuls in other orders, flax's LayerNorm and the port's take
the variance and ``rsqrt`` in their own ways, and ``erf`` and ``exp``
round differently in the last place. JAX's golden tests hold the same
models to an independent torch forward at ``rtol = atol = 2e-4``
(``tests/test_import.py``), the ceiling; FLOAT_TOL is 20 times tighter,
and the largest error measured here is 1.8e-7 on logits up to 0.71
(a few float32 ulps).

Also: the re-keying functions key for key; the port's float models
against the JAX tests' independent torch forwards; the INT8 SIM model
within ``tests/test_float_ref.py``'s bounds of the float model on the
same weights; the registry's ``*_fp32`` entries.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ivit_tpu.models.import_swin import torch_swin_to_params as jax_swin_to_params
from ivit_tpu.models.import_torch import merge_params as jax_merge
from ivit_tpu.models.import_torch import torch_vit_to_params as jax_vit_to_params
from ivit_tpu.models.registry import MODEL_REGISTRY as JAX_REGISTRY
from ivit_tpu.models.swin_float import FloatSwinTransformer as JaxFloatSwin
from ivit_tpu.models.swin_float import swin_quant_params_to_float as jax_swin_rekey
from ivit_tpu.models.vit_float import FloatVisionTransformer as JaxFloatViT
from ivit_tpu.models.vit_float import quant_params_to_float as jax_vit_rekey
from ivit_tpu_torch.models import FLOAT_REGISTRY, create_model
from ivit_tpu_torch.models.import_swin import torch_swin_to_params
from ivit_tpu_torch.models.import_torch import torch_vit_to_params
from ivit_tpu_torch.models.swin_float import swin_quant_params_to_float
from ivit_tpu_torch.models.vit_float import quant_params_to_float
from ivit_tpu_torch.nn import flax_variables, load_flax_variables
import test_import
from test_import import fake_torch_sd
from test_import_swin import _torch_swin_forward, fake_swin_sd
from tests.torch_threads import one_torch_thread  # noqa: F401

VIT = dict(img_size=16, patch_size=8, num_classes=8, embed_dim=32, depth=2, num_heads=4)
SWIN = dict(img_size=32, patch_size=2, num_classes=8, embed_dim=16, depths=(2, 2), num_heads=(2, 4), window_size=4)
FLOAT_TOL = 1e-5  # rtol = atol (module docstring)


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(a) for p, a in jax.tree_util.tree_leaves_with_path(tree)}


def _scaled(sd):
    return {k: (v * 0.2).astype(np.float32) for k, v in sd.items()}


def _images(seed, n, size):
    return np.random.default_rng(seed).standard_normal((n, size, size, 3)).astype(np.float32)


def _vit_pair():
    """JAX's float ViT, its params imported from the scaled state dict by
    the library path, and the port's float ViT on them."""
    sd = _scaled(fake_torch_sd(D=32, depth=2, heads=4, p=8, img=16, classes=8))
    jm = JaxFloatViT(**VIT)
    init = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)))
    params = jax.tree.map(np.asarray, jax_merge(init["params"], jax_vit_rekey(jax_vit_to_params(sd))))
    tm = load_flax_variables(create_model("deit_tiny_fp32", "cpu", **VIT), {"params": params})
    return sd, jm, params, tm


def _swin_pair(ape=False):
    sd = _scaled(fake_swin_sd(D=16, depths=(2, 2), heads=(2, 4), p=2, ws=4))
    if ape:
        sd["absolute_pos_embed"] = np.random.default_rng(9).normal(0, 0.2, (1, 256, 16)).astype(np.float32)
    jm = JaxFloatSwin(**SWIN, ape=ape)
    init = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    params = jax.tree.map(np.asarray, jax_merge(init["params"], jax_swin_rekey(jax_swin_to_params(sd))))
    tm = load_flax_variables(create_model("swin_tiny_fp32", "cpu", **SWIN, ape=ape), {"params": params})
    return sd, jm, params, tm


def _check_close(ours, theirs):
    err = np.abs(ours - theirs)
    assert np.all(err <= FLOAT_TOL + FLOAT_TOL * np.abs(theirs)), f"largest error {err.max()}"


def test_float_vit_matches_jax():
    _, jm, params, tm = _vit_pair()
    x = _images(3, 4, 16)
    theirs = np.asarray(jax.jit(jm.apply)({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        ours = tm(torch.from_numpy(x)).numpy()
    _check_close(ours, theirs)


@pytest.mark.parametrize("ape", [False, True], ids=["no-ape", "ape"])
def test_float_swin_matches_jax(ape):
    _, jm, params, tm = _swin_pair(ape)
    x = _images(5, 2, 32)
    theirs = np.asarray(jax.jit(jm.apply)({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        ours = tm(torch.from_numpy(x)).numpy()
    _check_close(ours, theirs)


def test_float_models_match_the_torch_golden_forwards():
    """The JAX tests' independent torch forwards on the state dicts
    (conv patch embed, ``F.layer_norm``, erf GELU): the port's importers
    and float models reproduce them, as JAX's do."""
    sd, _, _, tm = _vit_pair()
    x = _images(3, 2, 16)
    golden = test_import.TestImporterGolden()._torch_forward(sd, x, 32, 4, 8)
    with torch.no_grad():
        _check_close(tm(torch.from_numpy(x)).numpy(), golden)
    sd, _, _, tm = _swin_pair()
    x = _images(5, 2, 32)
    golden = _torch_swin_forward(sd, x, (2, 2), (2, 4), 2, 4)
    with torch.no_grad():
        _check_close(tm(torch.from_numpy(x)).numpy(), golden)


def test_float_model_carries_flax_names():
    """Every leaf of JAX's float params lands in the port's model under
    its flax name and comes back unchanged."""
    for _, _, params, tm in (_vit_pair(), _swin_pair(ape=True)):
        ours, theirs = _flat(flax_variables(tm)), _flat({"params": params, "quant_stats": {}})
        assert ours.keys() == theirs.keys()
        for name, value in theirs.items():
            np.testing.assert_array_equal(ours[name], value, err_msg=name)


@pytest.mark.parametrize("family", ["vit", "swin-ape"])
def test_quant_params_to_float_key_for_key(family):
    if family == "vit":
        tree = jax_vit_to_params(fake_torch_sd())
        ours, theirs = quant_params_to_float(torch_vit_to_params(fake_torch_sd())), jax_vit_rekey(tree)
    else:
        sd = fake_swin_sd(depths=(2, 2))
        sd["absolute_pos_embed"] = np.ones((1, 64, 16), np.float32)
        ours, theirs = swin_quant_params_to_float(torch_swin_to_params(sd)), jax_swin_rekey(jax_swin_to_params(sd))
    ours, theirs = _flat(ours), _flat(theirs)
    assert list(ours) == list(theirs)
    for name, value in theirs.items():
        np.testing.assert_array_equal(ours[name], value, err_msg=name)


def _calibrated(name, cfg, size, n=8):
    """A QAT model seeded on the CPU, its ranges set by train-mode
    forwards over four batches (the first assigns them), as
    ``tests/test_float_ref.py`` settles JAX's; and the float model on its
    weights by ``quant_params_to_float``."""
    qm = create_model(name, "cpu", seed=1, drop_path_rate=0.0, **cfg)
    with torch.no_grad():
        for seed in (0, 10, 11, 12):
            qm(torch.from_numpy(_images(seed, n, size)), train=True)
    rekey = swin_quant_params_to_float if name.startswith("swin") else quant_params_to_float
    fm = create_model(f"{name}_fp32", "cpu", **cfg)
    return qm, load_flax_variables(fm, {"params": rekey(flax_variables(qm)["params"])})


@pytest.mark.parametrize("family", ["vit", "swin"])
def test_int8_sim_close_to_float_model(family):
    """``tests/test_float_ref.py``'s proximity: the INT8 SIM logits
    correlate with the float model's on the same weights (> 0.95 for the
    ViT, > 0.9 for the Swin, JAX's bounds) and, for the ViT, agree in
    top-1 on at least three quarters of the images."""
    if family == "vit":
        cfg = dict(img_size=32, patch_size=8, num_classes=10, embed_dim=64, depth=2, num_heads=4)
        qm, fm = _calibrated("deit_tiny", cfg, 32)
        x = torch.from_numpy(_images(0, 8, 32))
    else:
        cfg = dict(img_size=16, patch_size=2, num_classes=10, embed_dim=16, depths=(2, 2), num_heads=(2, 4),
                   window_size=4)
        qm, fm = _calibrated("swin_tiny", cfg, 16, n=4)
        x = torch.from_numpy(_images(0, 4, 16))
    with torch.no_grad():
        f_logits, q_logits = fm(x).numpy(), qm(x).numpy()
    corr = np.corrcoef(f_logits.ravel(), q_logits.ravel())[0, 1]
    if family == "vit":
        assert corr > 0.95, corr
        agree = np.mean(np.argmax(f_logits, -1) == np.argmax(q_logits, -1))
        assert agree >= 0.75, agree
    else:
        assert corr > 0.9, corr


def test_fp32_registry_entries():
    """The eight ``*_fp32`` names with JAX's configurations, and
    ``tests/test_float_ref.py``'s two built."""
    assert sorted(FLOAT_REGISTRY) == sorted(n for n in JAX_REGISTRY if n.endswith("_fp32"))
    for name, factory in FLOAT_REGISTRY.items():
        assert factory.keywords == JAX_REGISTRY[name].keywords, name
        assert factory.func.__name__ == JAX_REGISTRY[name].func.__name__, name
    m = create_model("deit_small_fp32", "cpu")
    assert m.embed_dim == 384 and m.depth == 12
    m = create_model("swin_base_fp32", "cpu")
    assert m.config["embed_dim"] == 128
