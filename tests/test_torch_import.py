"""The port's checkpoint importers against JAX's on the CPU, tolerance 0.

Both packages' importers are numpy, so every tree they give is compared
leaf for leaf with ``assert_array_equal`` (values, shapes, float32):
``torch_vit_to_params``, ``npz_vit_to_params``, ``torch_swin_to_params``,
``merge_params`` (a head whose shape differs and a missing key keep the
initial value, with JAX's log lines), the bicubic resize
(``bicubic_resize_nchw``, ``resize_pos_embed``) and ``load_pretrained``
on a bare ``.pth``, one wrapped in ``{"model": ...}``, a ``.pth.tar``
that pickles more than tensors and an augreg ``.npz``: the port model's
``flax_variables`` afterwards equal JAX's ``load_pretrained`` on the
same initial parameters. The state dicts are JAX's tests' own
(``tests/test_import.py:fake_torch_sd``,
``tests/test_import_swin.py:fake_swin_sd``); a checkpoint on a 4×4 grid
loads into a model on a 2×2 grid through the resize.
"""

import argparse
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ivit_tpu.models import SwinTransformer as JaxSwin
from ivit_tpu.models import VisionTransformer as JaxViT
from ivit_tpu.models import import_swin as jax_import_swin
from ivit_tpu.models import import_torch as jax_import
from ivit_tpu_torch.models import create_model
from ivit_tpu_torch.models import import_swin, import_torch
from ivit_tpu_torch.nn import flax_variables, load_flax_variables
from test_import import fake_torch_sd
from test_import_swin import fake_swin_sd
from tests.torch_threads import one_torch_thread  # noqa: F401

VIT = dict(img_size=16, patch_size=8, num_classes=10, embed_dim=32, depth=2, num_heads=4)
SWIN = dict(img_size=16, patch_size=2, num_classes=10, embed_dim=16, depths=(2, 2), num_heads=(2, 4), window_size=4)


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(a) for p, a in jax.tree_util.tree_leaves_with_path(tree)}


def _assert_trees_equal(ours, theirs):
    ours, theirs = _flat(ours), _flat(theirs)
    assert ours.keys() == theirs.keys()
    for name, value in theirs.items():
        assert ours[name].dtype == value.dtype, name
        np.testing.assert_array_equal(ours[name], value, err_msg=name)


def augreg_npz(sd, heads):
    """``sd``'s weights in the augreg ``.npz`` layout (as
    ``tests/test_import.py``'s npz-agreement test builds it)."""
    D = sd["cls_token"].shape[-1]
    hd = D // heads
    depth = 1 + max(int(k.split(".")[1]) for k in sd if k.startswith("blocks."))
    g = {
        "cls": sd["cls_token"],
        "Transformer/posembed_input/pos_embedding": sd["pos_embed"],
        "embedding/kernel": sd["patch_embed.proj.weight"].transpose(2, 3, 1, 0),
        "embedding/bias": sd["patch_embed.proj.bias"],
        "Transformer/encoder_norm/scale": sd["norm.weight"],
        "Transformer/encoder_norm/bias": sd["norm.bias"],
        "head/kernel": sd["head.weight"].T,
        "head/bias": sd["head.bias"],
    }
    for i in range(depth):
        src, b = f"Transformer/encoderblock_{i}", f"blocks.{i}"
        att = f"{src}/MultiHeadDotProductAttention_1"
        w, bias = sd[f"{b}.attn.qkv.weight"], sd[f"{b}.attn.qkv.bias"]
        for j, n in enumerate(("query", "key", "value")):
            g[f"{att}/{n}/kernel"] = w[j * D:(j + 1) * D].T.reshape(D, heads, hd)
            g[f"{att}/{n}/bias"] = bias[j * D:(j + 1) * D].reshape(heads, hd)
        g[f"{att}/out/kernel"] = sd[f"{b}.attn.proj.weight"].T.reshape(heads, hd, D)
        g[f"{att}/out/bias"] = sd[f"{b}.attn.proj.bias"]
        g[f"{src}/LayerNorm_0/scale"], g[f"{src}/LayerNorm_0/bias"] = sd[f"{b}.norm1.weight"], sd[f"{b}.norm1.bias"]
        g[f"{src}/LayerNorm_2/scale"], g[f"{src}/LayerNorm_2/bias"] = sd[f"{b}.norm2.weight"], sd[f"{b}.norm2.bias"]
        g[f"{src}/MlpBlock_3/Dense_0/kernel"] = sd[f"{b}.mlp.fc1.weight"].T
        g[f"{src}/MlpBlock_3/Dense_0/bias"] = sd[f"{b}.mlp.fc1.bias"]
        g[f"{src}/MlpBlock_3/Dense_1/kernel"] = sd[f"{b}.mlp.fc2.weight"].T
        g[f"{src}/MlpBlock_3/Dense_1/bias"] = sd[f"{b}.mlp.fc2.bias"]
    return g


@pytest.mark.parametrize("qkv_bias", [True, False], ids=["qkv-bias", "no-qkv-bias"])
def test_torch_vit_to_params_matches_jax(qkv_bias):
    sd = fake_torch_sd()
    if not qkv_bias:
        sd = {k: v for k, v in sd.items() if not k.endswith("attn.qkv.bias")}
    _assert_trees_equal(import_torch.torch_vit_to_params(sd), jax_import.torch_vit_to_params(sd))
    # torch tensors import as their arrays do
    tensors = {k: torch.from_numpy(v) for k, v in sd.items()}
    _assert_trees_equal(import_torch.torch_vit_to_params(tensors), jax_import.torch_vit_to_params(sd))


def test_npz_vit_to_params_matches_jax():
    g = augreg_npz(fake_torch_sd(), heads=4)
    _assert_trees_equal(import_torch.npz_vit_to_params(g, 2), jax_import.npz_vit_to_params(g, 2))
    # and the same weights by either route, as JAX's test holds its own
    _assert_trees_equal(import_torch.npz_vit_to_params(g, 2), import_torch.torch_vit_to_params(fake_torch_sd()))


@pytest.mark.parametrize("extras", [False, True], ids=["plain", "ape-and-buffers"])
def test_torch_swin_to_params_matches_jax(extras):
    sd = fake_swin_sd(depths=(2, 2))
    if extras:
        # the official checkpoints' buffers (not parameters) and an
        # absolute position embedding
        sd["absolute_pos_embed"] = np.ones((1, 64, 16), np.float32)
        for i in range(2):
            for j in range(2):
                sd[f"layers.{i}.blocks.{j}.attn.relative_position_index"] = np.zeros((16, 16), np.int64)
    _assert_trees_equal(import_swin.torch_swin_to_params(sd), jax_import_swin.torch_swin_to_params(sd))


def _jax_vit_init(cfg=VIT):
    v = jax.jit(lambda x: JaxViT(**cfg).init(jax.random.PRNGKey(0), x, train=False))(jnp.zeros((1, 16, 16, 3)))
    return jax.tree.map(np.asarray, v)


def _jax_swin_init():
    v = jax.jit(lambda x: JaxSwin(**SWIN).init(jax.random.PRNGKey(0), x, train=False))(jnp.zeros((1, 16, 16, 3)))
    return jax.tree.map(np.asarray, v)


def test_merge_params_matches_jax(caplog):
    """A head of another class count and a missing norm keep their
    initial values, with the same log lines as JAX's."""
    init = _jax_vit_init()["params"]
    sd = {k: v for k, v in fake_torch_sd(classes=8).items() if not k.startswith("norm.")}
    loaded = import_torch.torch_vit_to_params(sd)
    with caplog.at_level(logging.WARNING):
        ours = import_torch.merge_params(init, loaded)
        ours_log = [r.getMessage() for r in caplog.records]
        caplog.clear()
        theirs = jax_import.merge_params(init, loaded)
        theirs_log = [r.getMessage() for r in caplog.records]
    _assert_trees_equal(ours, theirs)
    assert ours_log == theirs_log
    assert any("shape mismatch at head/kernel" in m for m in ours_log)
    assert "missing in checkpoint: norm" in ours_log
    np.testing.assert_array_equal(ours["head"]["kernel"], init["head"]["kernel"])


@pytest.mark.parametrize("grids", [(4, 2), (2, 4), (10, 14), (24, 14), (7, 7)])
def test_bicubic_resize_matches_jax(grids):
    """Tolerance 0 against JAX's numpy resize; and, as JAX's own test holds
    it, against torch's ``F.interpolate`` to float32 rounding."""
    old, new = grids
    posemb = np.random.default_rng(old * 100 + new).normal(size=(1, 1 + old * old, 16)).astype(np.float32)
    ours = import_torch.resize_pos_embed(posemb, 1 + new * new)
    np.testing.assert_array_equal(ours, jax_import.resize_pos_embed(posemb, 1 + new * new))
    g = posemb[0, 1:].reshape(1, old, old, 16).transpose(0, 3, 1, 2).copy()
    np.testing.assert_array_equal(import_torch.bicubic_resize_nchw(g, new, new),
                                  jax_import.bicubic_resize_nchw(g, new, new))
    ref = F.interpolate(torch.from_numpy(g), size=(new, new), mode="bicubic", align_corners=False)
    ref = ref.permute(0, 2, 3, 1).reshape(1, new * new, 16).numpy()
    np.testing.assert_array_equal(ours[:, :1], posemb[:, :1])
    np.testing.assert_allclose(ours[:, 1:], ref, rtol=1e-5, atol=4e-6)


def _save(tmp_path, kind, sd):
    path = tmp_path / {"pth": "ckpt.pth", "pth-model": "ckpt.pth", "pth-tar": "checkpoint.pth.tar",
                       "npz": "ckpt.npz"}[kind]
    tensors = {k: torch.from_numpy(v) for k, v in sd.items()}
    if kind == "pth":
        torch.save(tensors, path)
    elif kind == "pth-model":
        torch.save({"model": tensors}, path)
    elif kind == "pth-tar":
        # the reference's training checkpoints pickle their arguments too
        torch.save({"model": tensors, "args": argparse.Namespace(lr=1e-6), "epoch": 3}, path)
    else:
        np.savez(path, **augreg_npz(sd, heads=4))
    return str(path)


@pytest.mark.parametrize("kind", ["pth", "pth-model", "pth-tar", "npz"])
def test_load_pretrained_matches_jax(kind, tmp_path):
    """A 4×4-grid checkpoint (pos_embed resized to the model's 2×2) with
    an 8-class head (kept at init in a 10-class model), into a port QAT
    ViT holding JAX's initial variables: its variables afterwards equal
    JAX's ``load_pretrained`` on the same initial parameters, and its
    ranges are untouched."""
    variables = _jax_vit_init()
    path = _save(tmp_path, kind, fake_torch_sd(D=32, depth=2, heads=4, p=8, img=32, classes=8))
    model = load_flax_variables(create_model("deit_tiny", "cpu", **VIT), variables)
    assert import_torch.load_pretrained(path, "deit_tiny", model) is model
    ours = flax_variables(model)
    _assert_trees_equal(ours["params"], jax_import.load_pretrained(path, "deit_tiny", variables["params"]))
    _assert_trees_equal(ours["quant_stats"], variables["quant_stats"])
    assert ours["params"]["pos_embed"].shape == (1, 5, 32)


def test_load_pretrained_swin_matches_jax(tmp_path):
    variables = _jax_swin_init()
    sd = fake_swin_sd(depths=(2, 2))
    path = str(tmp_path / "swin.pth")
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}}, path)
    model = load_flax_variables(create_model("swin_tiny", "cpu", **SWIN), variables)
    import_torch.load_pretrained(path, "swin_tiny", model)
    _assert_trees_equal(flax_variables(model)["params"],
                        jax_import.load_pretrained(path, "swin_tiny", variables["params"]))


def test_load_pretrained_auto_exits():
    model = create_model("deit_tiny", "cpu", **VIT)
    with pytest.raises(SystemExit, match=r"ROADMAP\.md §1 item 9.*--pretrained <local path>"):
        import_torch.load_pretrained("auto", "deit_tiny", model)
