"""Port ``deploy.ingest_torch`` ≡ ``ivit_tpu.deploy.ingest_torch``, bit for bit.

A reference-style QAT state dict — the ``weight_integer`` /
``bias_integer`` / ``*_scaling_factor`` buffers under the names the JAX
ingester reads — is built with numpy from a seeded tiny synthetic
artifact (its integers and calibrated scales, so the engines see
non-degenerate values), for a ViT and for a Swin. Both ingesters turn it
into an artifact: every array and the config must be equal (tolerance
0), the artifact must pass the port's schema check, and the port's CPU
engine must give the JAX engine's logits on it. The loud failures
(missing buffer, unpopulated scale, Swin at the wrong resolution) must
raise the same errors with the same messages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ivit_tpu.deploy import build_vit_infer as jax_build_vit_infer
from ivit_tpu.deploy import ingest_torch as jax_ingest
from ivit_tpu.deploy.swin_engine import build_swin_infer as jax_build_swin_infer
from ivit_tpu.models.swin import relative_position_index, sw_attn_mask
from ivit_tpu_torch.deploy import ingest_torch
from ivit_tpu_torch.deploy.artifact import validate_artifact
from ivit_tpu_torch.deploy.engine import build_vit_infer
from ivit_tpu_torch.deploy.swin_artifact import validate_swin_artifact
from ivit_tpu_torch.deploy.swin_engine import build_swin_infer
from ivit_tpu_torch.deploy.swin_synthetic import synthetic_swin_artifact
from ivit_tpu_torch.deploy.synthetic import synthetic_vit_artifact
from tests.torch_threads import one_torch_thread  # noqa: F401
from torch_reference_state import act, linear, mlp, norm, patch_embed, vit_state

# tiny sizes with the head counts of deit_tiny and swin_tiny (the
# converter takes them from the registered configs); Swin: stages 1-2
# shifted and masked, stage 3 one window, stage 4's window clamped to 2
VIT_TINY = dict(img_size=16, patch_size=8, embed_dim=96, depth=2, num_heads=3, num_classes=10)
SWIN_TINY = dict(img_size=32, patch_size=2, num_classes=8, embed_dim=12, depths=(2, 2, 2, 2), num_heads=(3, 6, 12, 24),
                 window_size=4)


def reference_vit_state(seed=0, softmax_bits=16, gelu_stable=False, **cfg):
    """A reference ViT/DeiT QAT state dict (numpy) holding the integers
    and scales of a seeded synthetic artifact."""
    return vit_state(synthetic_vit_artifact("deit_tiny", seed=seed, softmax_bits=softmax_bits,
                                            gelu_stable=gelu_stable, **{**VIT_TINY, **cfg}))


def reference_swin_state(seed=0, with_index=True):
    """A reference Swin QAT state dict (numpy) holding the integers and
    scales of a seeded synthetic artifact, with a seeded float
    relative-position table per block, each shifted block's ``attn_mask``
    and (``with_index``) the ``relative_position_index`` buffers."""
    a = synthetic_swin_artifact("swin_tiny", seed=seed, **SWIN_TINY)
    rng = np.random.default_rng(seed + 100)
    sd = {}
    patch_embed(sd, a)
    act(sd, "patch_embed.qact_before_norm", a["s_before_norm"])
    norm(sd, "patch_embed.norm", a["patch_norm"])
    act(sd, "patch_embed.qact", a["embed_scale"])
    act(sd, "qact1", a["tokens_scale"])
    for i, stage in enumerate(a["stages"]):
        for j, blk in enumerate(stage["blocks"]):
            b = f"layers.{i}.blocks.{j}"
            ws, heads = blk["ws"], blk["heads"]
            table = (rng.standard_normal(((2 * ws - 1) ** 2, heads)) * 0.02).astype(np.float32)
            sd[f"{b}.attn.relative_position_bias_table"] = table
            act(sd, f"{b}.attn.qact_table", np.abs(table).max() / 127)
            if with_index:
                sd[f"{b}.attn.relative_position_index"] = relative_position_index(ws).astype(np.int64)
            if blk["shift"]:
                sd[f"{b}.attn_mask"] = sw_attn_mask(blk["res"], blk["res"], ws, blk["shift"])
            norm(sd, f"{b}.norm1", blk["norm1"])
            act(sd, f"{b}.qact1", blk["s_qact1"])
            linear(sd, f"{b}.attn.qkv", blk["qkv"], blk["s_qact1"])
            act(sd, f"{b}.attn.qact1", blk["s_attn_qact1"])
            act(sd, f"{b}.attn.qact_attn1", blk["s_attn1"])
            act(sd, f"{b}.attn.qact2", blk["s_bias"])
            act(sd, f"{b}.attn.qact3", blk["s_attn_out"])
            linear(sd, f"{b}.attn.proj", blk["proj"], blk["s_attn_out"])
            act(sd, f"{b}.attn.qact4", blk["s_attn_proj"])
            act(sd, f"{b}.qact2", blk["s_res1"])
            mlp(sd, b, blk)
        if "downsample" in stage:
            ds, d = stage["downsample"], f"layers.{i}.downsample"
            act(sd, f"{d}.qact1", ds["s_qact1"])
            norm(sd, f"{d}.norm", ds["norm"])
            linear(sd, f"{d}.reduction", ds["reduction"], ds["s_qact1"])
            act(sd, f"{d}.qact2", ds["s_out"])
    norm(sd, "norm", a["norm"])
    act(sd, "qact2", a["s_qact2"])
    act(sd, "qact3", a["s_qact3"])
    linear(sd, "head", a["head"], a["s_qact3"])
    return sd


def assert_same(ours, theirs, path="artifact"):
    """Equal nested artifacts: same keys, list lengths, dtypes and values."""
    if isinstance(theirs, dict):
        assert isinstance(ours, dict) and set(ours) == set(theirs), path
        for k in theirs:
            assert_same(ours[k], theirs[k], f"{path}[{k!r}]")
    elif isinstance(theirs, (list, tuple)):
        assert type(ours) is type(theirs) and len(ours) == len(theirs), path
        for i, (o, t) in enumerate(zip(ours, theirs)):
            assert_same(o, t, f"{path}[{i}]")
    elif theirs is None or isinstance(theirs, (bool, int, float, str)):
        assert type(ours) is type(theirs) and ours == theirs, path
    else:
        o, t = np.asarray(ours), np.asarray(theirs)
        assert o.dtype == t.dtype and o.shape == t.shape, f"{path}: {o.dtype}{o.shape} vs {t.dtype}{t.shape}"
        np.testing.assert_array_equal(o, t, err_msg=path)


VIT_SPECS = {"sm16_rowmax": (16, False), "sm8_stable": (8, True)}


@pytest.fixture(scope="module", params=sorted(VIT_SPECS))
def vit_pair(request):
    bits, stable = VIT_SPECS[request.param]
    sd = reference_vit_state(softmax_bits=bits, gelu_stable=stable)
    kw = dict(num_heads=VIT_TINY["num_heads"], softmax_bits=bits, gelu_stable=stable)
    return sd, ingest_torch.torch_vit_state_to_artifact(sd, **kw), jax_ingest.torch_vit_state_to_artifact(sd, **kw)


@pytest.fixture(scope="module", params=[True, False], ids=["index-buffers", "geometry-index"])
def swin_pair(request):
    sd = reference_swin_state(with_index=request.param)
    kw = dict(num_heads=SWIN_TINY["num_heads"], img_size=SWIN_TINY["img_size"])
    return sd, ingest_torch.torch_swin_state_to_artifact(sd, **kw), jax_ingest.torch_swin_state_to_artifact(sd, **kw)


def _images(n, size, seed=7):
    return np.random.default_rng(seed).standard_normal((n, size, size, 3)).astype(np.float32)


def test_vit_ingest_matches_jax(vit_pair):
    _, ours, theirs = vit_pair
    assert_same(ours, theirs)
    validate_artifact(ours)
    assert ours["config"]["depth"] == VIT_TINY["depth"] and ours["config"]["img_size"] == VIT_TINY["img_size"]


def test_vit_ingested_logits_match_jax_engine(vit_pair):
    _, ours, _ = vit_pair
    images = _images(3, VIT_TINY["img_size"])
    logits = build_vit_infer(ours, "cpu")(torch.from_numpy(images)).numpy()
    np.testing.assert_array_equal(logits, np.asarray(jax_build_vit_infer(ours, use_pallas=False)(jnp.asarray(images))))
    assert logits.shape == (3, VIT_TINY["num_classes"]) and not np.array_equal(logits[0], logits[1])


def test_swin_ingest_matches_jax(swin_pair):
    _, ours, theirs = swin_pair
    assert_same(ours, theirs)
    validate_swin_artifact(ours)
    assert ours["stages"][0]["blocks"][1]["mask_int"] is not None  # stage 1 block 1 is shifted


def test_swin_ingested_logits_match_jax_engine(swin_pair):
    _, ours, _ = swin_pair
    images = _images(3, SWIN_TINY["img_size"])
    logits = build_swin_infer(ours, "cpu")(torch.from_numpy(images)).numpy()
    theirs = jax.jit(jax_build_swin_infer(ours, use_pallas=False))(jnp.asarray(images))
    np.testing.assert_array_equal(logits, np.asarray(theirs))


@pytest.mark.parametrize("wrapped", [True, False], ids=["model-key", "bare"])
def test_unwrap_state_dict_matches_jax(wrapped):
    sd = {k: torch.from_numpy(np.array(v)) for k, v in reference_vit_state().items()}
    obj = {"model": sd, "epoch": 3} if wrapped else sd
    ours, theirs = ingest_torch.unwrap_state_dict(obj), jax_ingest.unwrap_state_dict(obj)
    assert set(ours) == set(sd)
    assert_same(ours, theirs)
    assert all(isinstance(v, np.ndarray) for v in ours.values())


def _raised(fn, *args, **kwargs):
    with pytest.raises(Exception) as info:
        fn(*args, **kwargs)
    return type(info.value), str(info.value)


def test_missing_buffer_raises_jax_keyerror():
    sd = reference_vit_state()
    del sd["blocks.1.attn.qact1.act_scaling_factor"]
    ours = _raised(ingest_torch.torch_vit_state_to_artifact, sd, num_heads=3)
    assert ours == _raised(jax_ingest.torch_vit_state_to_artifact, sd, num_heads=3)
    assert ours[0] is KeyError and "blocks.1.attn.qact1.act_scaling_factor" in ours[1]


def test_unpopulated_scale_raises_jax_valueerror():
    sd = reference_vit_state()
    sd["blocks.0.mlp.qact_gelu.act_scaling_factor"] = np.zeros(1, np.float32)
    ours = _raised(ingest_torch.torch_vit_state_to_artifact, sd, num_heads=3)
    assert ours == _raised(jax_ingest.torch_vit_state_to_artifact, sd, num_heads=3)
    assert ours[0] is ValueError and "never populated" in ours[1]


@pytest.mark.parametrize("img_size", [64, 8])
def test_swin_wrong_img_size_raises_jax_valueerror(img_size):
    """At 64 the geometry-derived mask disagrees with the checkpoint's; at
    8 stage 1's grid is one window, so it would not shift, yet the
    checkpoint holds its mask."""
    sd = reference_swin_state()
    heads = SWIN_TINY["num_heads"]
    ours = _raised(ingest_torch.torch_swin_state_to_artifact, sd, num_heads=heads, img_size=img_size)
    assert ours == _raised(jax_ingest.torch_swin_state_to_artifact, sd, num_heads=heads, img_size=img_size)
    assert ours[0] is ValueError and "attn_mask" in ours[1]


def test_swin_head_count_mismatch_raises_jax_valueerror():
    sd = reference_swin_state()
    ours = _raised(ingest_torch.torch_swin_state_to_artifact, sd, num_heads=(3, 6, 12))
    assert ours == _raised(jax_ingest.torch_swin_state_to_artifact, sd, num_heads=(3, 6, 12))
    assert ours[0] is ValueError
