"""Port engine ≡ JAX engine, bit for bit (tolerance 0), on the CPU.

Tiny artifacts are frozen with JAX (``init(train=True)`` then
``freeze_vit``, as ``bench.py`` does) and run through
``ivit_tpu.deploy.build_vit_infer(use_pallas=False)`` and the port's
``build_vit_infer`` on the same numpy images. The synthetic artifact
builder is held to ``freeze_vit``'s schema and to the JAX engine too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ivit_tpu.deploy import build_vit_infer as jax_build_vit_infer
from ivit_tpu.deploy import freeze_vit
from ivit_tpu.models import VisionTransformer
from ivit_tpu.utils import save_artifact as jax_save_artifact
from ivit_tpu_torch.deploy.artifact import artifact_spec, artifact_to_torch, validate_artifact
from ivit_tpu_torch.deploy.engine import build_vit_infer
from ivit_tpu_torch.deploy.synthetic import nonzero_probability_share, synthetic_vit_artifact
from ivit_tpu_torch.utils import load_artifact, save_artifact

TINY = dict(img_size=16, patch_size=8, embed_dim=128, depth=2, num_heads=4)
# (softmax_bits, gelu_stable, JAX engine kwargs): the shipped sm8 +
# stable-GELU configuration and the reference-spec sm16 + row-max one
CONFIGS = {
    "sm8_stable": (8, True, {}),
    "sm16_rowmax": (16, False, {"attn_v_mode": "exact"}),
}


def _images(n, size=16, seed=42):
    return np.random.default_rng(seed).standard_normal((n, size, size, 3)).astype(np.float32)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def jax_frozen(request):
    bits, stable, jax_kw = CONFIGS[request.param]
    model = VisionTransformer(**TINY, softmax_bits=bits, gelu_stable=stable)
    init = jax.jit(lambda rng, x: model.init(rng, x, train=True))
    variables = init(jax.random.PRNGKey(1), jnp.asarray(_images(4, seed=0)))
    artifact = freeze_vit(model, jax.tree.map(np.asarray, variables))
    return artifact, jax_kw


def _jax_logits(artifact, images, **kw):
    return np.asarray(jax_build_vit_infer(artifact, use_pallas=False, **kw)(jnp.asarray(images)))


def test_engine_matches_jax_engine(jax_frozen):
    artifact, jax_kw = jax_frozen
    images = _images(3)
    ours = build_vit_infer(artifact)(torch.from_numpy(images)).numpy()
    np.testing.assert_array_equal(ours, _jax_logits(artifact, images, **jax_kw))
    assert np.all(np.isfinite(ours)) and ours.shape == (3, 1000)
    # batch 1 gives row 0 of the batch
    one = build_vit_infer(artifact)(torch.from_numpy(images[:1])).numpy()
    np.testing.assert_array_equal(one, ours[:1])


def test_engine_plain_and_kernel_paths_agree_on_cpu(jax_frozen):
    artifact, _ = jax_frozen
    images = torch.from_numpy(_images(2))
    np.testing.assert_array_equal(
        build_vit_infer(artifact, use_kernels=False)(images).numpy(),
        build_vit_infer(artifact)(images).numpy(),
    )


def test_artifact_roundtrips_through_jax_save(jax_frozen, tmp_path):
    artifact, _ = jax_frozen
    path = str(tmp_path / "vit.pkl")
    jax_save_artifact(path, artifact)
    loaded = load_artifact(path)
    validate_artifact(loaded)
    images = torch.from_numpy(_images(2))
    np.testing.assert_array_equal(
        build_vit_infer(loaded)(images).numpy(), build_vit_infer(artifact)(images).numpy()
    )
    # and the port's own writer produces a file the same loader reads
    save_artifact(str(tmp_path / "again.pkl"), loaded)
    again = load_artifact(str(tmp_path / "again.pkl"))
    np.testing.assert_array_equal(again["blocks"][1]["fc2"]["w"], artifact["blocks"][1]["fc2"]["w"])


def test_artifact_to_torch_dtypes(jax_frozen):
    artifact, _ = jax_frozen
    t = artifact_to_torch(artifact, "cpu")
    blk = t["blocks"][0]
    assert blk["qkv"]["w"].dtype == torch.int8 and blk["qkv"]["w"].shape == (128, 384)
    assert blk["fc2"]["b"].dtype == torch.int32
    assert blk["norm1"]["ratio"].dtype == torch.float32
    for key in ("r1", "scale", "r_out"):
        value = blk["attn"][key]
        assert isinstance(value, float) and float(np.float32(value)) == value


def _structure(tree):
    if isinstance(tree, dict):
        return {k: _structure(v) for k, v in tree.items() if k != "config"}
    if isinstance(tree, list):
        return [_structure(v) for v in tree]
    arr = np.asarray(tree)
    return (arr.dtype, arr.shape)


def test_synthetic_artifact_matches_freeze_schema_and_jax(jax_frozen):
    frozen, jax_kw = jax_frozen
    bits, stable = frozen["config"]["softmax_bits"], frozen["config"]["gelu_stable"]
    synth = synthetic_vit_artifact("deit_tiny", seed=3, softmax_bits=bits, gelu_stable=stable, **TINY)
    assert _structure(synth) == _structure(frozen)
    assert synth["config"] == frozen["config"]
    assert type(synth["input_scale"]) is type(frozen["input_scale"])

    images = _images(4, seed=9)
    ours = build_vit_infer(synth)(torch.from_numpy(images)).numpy()
    np.testing.assert_array_equal(ours, _jax_logits(synth, images, **jax_kw))
    # not degenerate: logits vary across classes and images, and most
    # attention probabilities are nonzero at this size (N = 5 tokens)
    assert np.std(ours) > 0 and not np.allclose(ours[0], ours[1])
    shares = nonzero_probability_share(synth, torch.from_numpy(images))
    assert min(shares) > 0.5, shares


def test_synthetic_artifact_is_seeded():
    a = synthetic_vit_artifact("deit_tiny", seed=5, **TINY)
    b = synthetic_vit_artifact("deit_tiny", seed=5, **TINY)
    c = synthetic_vit_artifact("deit_tiny", seed=6, **TINY)
    np.testing.assert_array_equal(a["blocks"][0]["qkv"]["w"], b["blocks"][0]["qkv"]["w"])
    assert a["blocks"][0]["s_attn_sm_in"] == b["blocks"][0]["s_attn_sm_in"]
    assert not np.array_equal(a["blocks"][0]["qkv"]["w"], c["blocks"][0]["qkv"]["w"])


def test_deit_small_schema():
    synth_cfg = dict(img_size=224, patch_size=16, embed_dim=384, depth=12, num_heads=6,
                     mlp_ratio=4.0, num_classes=1000, softmax_bits=8, gelu_stable=True)
    spec = artifact_spec(synth_cfg)
    assert spec["pos_q"][1] == (1, 197, 384)
    assert spec["blocks"][11]["fc1"]["w"][1] == (384, 1536)
    assert spec["patch_embed"]["w"][1] == (768, 384)


def test_broken_artifact_raises(jax_frozen):
    artifact, _ = jax_frozen
    broken = dict(artifact, head=dict(artifact["head"], w=artifact["head"]["w"].astype(np.int16)))
    with pytest.raises(ValueError, match="head"):
        build_vit_infer(broken)
    missing = {k: v for k, v in artifact.items() if k != "norm"}
    with pytest.raises(ValueError):
        build_vit_infer(missing)


def test_more_than_256_tokens_raises():
    synth = synthetic_vit_artifact("deit_tiny", img_size=136, patch_size=8, embed_dim=64,
                                   depth=1, num_heads=2, num_classes=8)  # N = 290
    with pytest.raises(ValueError, match="256"):
        build_vit_infer(synth)
