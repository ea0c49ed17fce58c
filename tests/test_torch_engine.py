"""Port engine ≡ JAX engine, bit for bit (tolerance 0), on the CPU, for
every ``kernels=`` route, against the JAX engine under both of its
``attn_v_mode`` values.

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
from ivit_tpu_torch.deploy.engine import KERNEL_NAMES, build_vit_infer, select_kernels
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
    ours = build_vit_infer(artifact, "cpu")(torch.from_numpy(images)).numpy()
    np.testing.assert_array_equal(ours, _jax_logits(artifact, images, **jax_kw))
    assert np.all(np.isfinite(ours)) and ours.shape == (3, 1000)
    # batch 1 gives row 0 of the batch
    one = build_vit_infer(artifact, "cpu")(torch.from_numpy(images[:1])).numpy()
    np.testing.assert_array_equal(one, ours[:1])


def test_engine_at_a_100_class_head_matches_jax_engine():
    """N = 100 at the head: the carried weight is zero-padded to 104
    columns (CUDA's ``torch._int_mm`` takes multiples of 8 only) and the
    logits are cut back to 100, equal to the JAX engine."""
    model = VisionTransformer(**TINY, num_classes=100, softmax_bits=8, gelu_stable=True)
    variables = jax.jit(lambda rng, x: model.init(rng, x, train=True))(
        jax.random.PRNGKey(2), jnp.asarray(_images(4, seed=0)))
    artifact = freeze_vit(model, jax.tree.map(np.asarray, variables))
    head = artifact_to_torch(artifact, "cpu")["head"]
    assert tuple(head["w"].shape) == (128, 104) and head["n"] == 100 and tuple(head["b"].shape) == (100,)
    images = _images(3)
    ours = build_vit_infer(artifact, "cpu")(torch.from_numpy(images)).numpy()
    assert ours.shape == (3, 100)
    np.testing.assert_array_equal(ours, _jax_logits(artifact, images))


def test_engine_plain_and_kernel_paths_agree_on_cpu(jax_frozen):
    artifact, _ = jax_frozen
    images = torch.from_numpy(_images(2))
    np.testing.assert_array_equal(
        build_vit_infer(artifact, "cpu", kernels=())(images).numpy(),
        build_vit_infer(artifact, "cpu")(images).numpy(),
    )


def test_artifact_roundtrips_through_jax_save(jax_frozen, tmp_path):
    artifact, _ = jax_frozen
    path = str(tmp_path / "vit.pkl")
    jax_save_artifact(path, artifact)
    loaded = load_artifact(path)
    validate_artifact(loaded)
    images = torch.from_numpy(_images(2))
    np.testing.assert_array_equal(
        build_vit_infer(loaded, "cpu")(images).numpy(), build_vit_infer(artifact, "cpu")(images).numpy()
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
    ours = build_vit_infer(synth, "cpu")(torch.from_numpy(images)).numpy()
    np.testing.assert_array_equal(ours, _jax_logits(synth, images, **jax_kw))
    # not degenerate: logits vary across classes and images, and most
    # attention probabilities are nonzero at this size (N = 5 tokens)
    assert np.std(ours) > 0 and not np.allclose(ours[0], ours[1])
    shares = nonzero_probability_share(synth, torch.from_numpy(images), device="cpu")
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
        build_vit_infer(broken, "cpu")
    missing = {k: v for k, v in artifact.items() if k != "norm"}
    with pytest.raises(ValueError):
        build_vit_infer(missing, "cpu")


def test_more_than_256_tokens_raises():
    """Over 256 tokens ``attention2`` and ``softmax`` raise (K2's and K6's
    row-sum bound); ``attention``, the default, runs K10 there."""
    synth = synthetic_vit_artifact("deit_tiny", img_size=136, patch_size=8, embed_dim=64,
                                   depth=1, num_heads=2, num_classes=8, softmax_bits=16,
                                   gelu_stable=False)  # N = 290
    for kernels in (("attention2", "layernorm"), ("softmax",)):
        with pytest.raises(ValueError, match="256"):
            build_vit_infer(synth, "cpu", kernels=kernels)
    assert build_vit_infer(synth, "cpu").kernels == {"attention", "layernorm"}
    # the plain path has no such bound
    assert build_vit_infer(synth, "cpu", kernels=("layernorm",)).kernels == {"layernorm"}


def test_engine_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works here")
    artifact = synthetic_vit_artifact("deit_tiny", seed=5, **TINY)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_vit_infer(artifact)
    with pytest.raises(RuntimeError):
        nonzero_probability_share(artifact, torch.from_numpy(_images(1)))


# ---- the reference-spec path: sm16 + row-max ShiftGELU, every route -----

A = ("layernorm", "attention2", "linear_gelu")
B = ("layernorm", "softmax", "gelu")
# every name a row-max model takes ("gelu_stable", K9, refuses one)
ROWMAX_NAMES = tuple(k for k in KERNEL_NAMES if k != "gelu_stable")
ROUTES = {
    "plain": (),
    "attention": ("attention",),
    "attention2": ("attention2",),
    "softmax": ("softmax",),
    "gelu": ("gelu",),
    "linear_gelu": ("linear_gelu",),
    "layernorm": ("layernorm",),
    "A": A,
    "B": B,
    "all": ROWMAX_NAMES,
}


@pytest.fixture(scope="module")
def sm16_rowmax():
    """A JAX-frozen tiny sm16 row-max artifact, images, and the JAX
    engine's logits (``use_pallas=False``) under each ``attn_v_mode``."""
    model = VisionTransformer(**TINY, softmax_bits=16, gelu_stable=False)
    init = jax.jit(lambda rng, x: model.init(rng, x, train=True))
    variables = init(jax.random.PRNGKey(2), jnp.asarray(_images(4, seed=3)))
    artifact = freeze_vit(model, jax.tree.map(np.asarray, variables))
    images = _images(3, seed=11)
    logits = {mode: _jax_logits(artifact, images, attn_v_mode=mode) for mode in ("f32", "exact")}
    # "f32" and "exact" give the same integers (every @V partial sum < 2^22)
    np.testing.assert_array_equal(logits["f32"], logits["exact"])
    return artifact, images, logits


@pytest.mark.parametrize("attn_v_mode", ["f32", "exact"])
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_routes_match_jax_engine(sm16_rowmax, route, attn_v_mode):
    """Every route equals the JAX engine under either of its
    ``attn_v_mode`` values (the port has one exact @V)."""
    artifact, images, logits = sm16_rowmax
    kernels = ROUTES[route]
    infer = build_vit_infer(artifact, "cpu", kernels=kernels)
    assert infer.kernels == select_kernels(artifact["config"], kernels)
    np.testing.assert_array_equal(infer(torch.from_numpy(images)).numpy(), logits[attn_v_mode])


def _cfg(**kw):
    cfg = dict(img_size=224, patch_size=16, embed_dim=384, depth=12, num_heads=6,
               mlp_ratio=4.0, num_classes=1000, softmax_bits=16, gelu_stable=False)
    cfg.update(kw)
    return cfg


@pytest.mark.parametrize(
    "cfg,kernels,expected",
    [
        (_cfg(), ROWMAX_NAMES, {"attention", "linear_gelu", "layernorm"}),
        (_cfg(), ("attention2", "softmax", "gelu"), {"attention2", "gelu"}),
        (_cfg(), A, set(A)),
        (_cfg(), B, set(B)),
        (_cfg(softmax_bits=8), ("attention", "softmax"), {"attention"}),
        (_cfg(gelu_stable=True), ("attention2", "layernorm"), {"attention2", "layernorm", "gelu_stable"}),
        (_cfg(mlp_ratio=3.0, embed_dim=160, num_heads=5), ("gelu", "layernorm"), {"gelu", "layernorm"}),
        (_cfg(), (), set()),
    ],
    ids=["precedence", "attention2_over_softmax", "A", "B", "softmax_superseded_at_8_bits",
         "stable_without_gelu_kernels", "gelu_any_width", "plain"],
)
def test_kernel_selection(cfg, kernels, expected):
    assert select_kernels(cfg, kernels) == expected


@pytest.mark.parametrize(
    "cfg,kernels,match",
    [
        (_cfg(), ("attention3",), "unknown"),
        (_cfg(img_size=384), ("softmax",), "256"),
        (_cfg(softmax_bits=8), ("softmax", "gelu"), "softmax_bits=8"),
        (_cfg(gelu_stable=True), ("attention2", "gelu"), "gelu_stable"),
        (_cfg(gelu_stable=True), ("linear_gelu",), "gelu_stable"),
    ],
    ids=["unknown", "tokens_256", "softmax_at_8_bits", "gelu_when_stable", "linear_gelu_when_stable"],
)
def test_kernel_selection_rejects(cfg, kernels, match):
    """A requested kernel that a gate turns off raises, naming the gate:
    the engine never runs a plain version in its place."""
    with pytest.raises(ValueError, match=match):
        select_kernels(cfg, kernels)


@pytest.mark.parametrize(
    "bits,stable,kernels,match",
    [(8, False, ("softmax",), "softmax_bits=8"), (16, True, ("gelu",), "gelu_stable"),
     (16, True, A, "gelu_stable")],
    ids=["softmax_at_8_bits", "gelu_when_stable", "A_when_stable"],
)
def test_gated_kernel_raises_at_build(bits, stable, kernels, match):
    artifact = synthetic_vit_artifact("deit_tiny", seed=5, softmax_bits=bits, gelu_stable=stable, **TINY)
    with pytest.raises(ValueError, match=match):
        build_vit_infer(artifact, "cpu", kernels=kernels)


def test_attention2_gate_fails_at_build_naming_the_block(sm16_rowmax):
    artifact, _, _ = sm16_rowmax
    blocks = [dict(b) for b in artifact["blocks"]]
    blocks[1]["s_attn_sm_in"] = np.float32(1e-6)  # 5 * 10^6 * 2^15 > 2^31
    broken = dict(artifact, blocks=blocks)
    with pytest.raises(ValueError, match="block 1"):
        build_vit_infer(broken, "cpu", kernels=A)
    build_vit_infer(broken, "cpu", kernels=B)  # K6 has no such gate
