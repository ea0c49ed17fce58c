"""Port Swin engine ≡ JAX Swin engine, bit for bit (tolerance 0), on the CPU.

A tiny Swin (the configuration of ``tests/test_swin_deploy.py``: img 16,
patch 2, embed 16, depths (2, 2), heads (2, 4), window 4) is initialized
with JAX and frozen with ``freeze_swin``, once per ``gelu_stable`` value.
Its stage-1 block 1 is shifted and masked; stage 2 has one window
(ws = res = 4, no shift). The same numpy images go through
``ivit_tpu.deploy.swin_engine.build_swin_infer(use_pallas=False)`` and the
port's ``build_swin_infer``. K7's plain version is held to the Pallas
kernel in interpret mode, the helpers to ``ivit_tpu.models.swin``'s, and
the token-mean pool to ``jnp.mean`` at 49 tokens.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ivit_tpu.deploy.swin_engine import build_swin_infer as jax_build_swin_infer
from ivit_tpu.deploy.swin_engine import freeze_swin
from ivit_tpu.kernels import _shiftmax_common as jax_k0
from ivit_tpu.kernels.window_attention_fused import fused_int8_window_attention as pallas_window_attention
from ivit_tpu.models import SwinTransformer
from ivit_tpu.models import swin as jax_swin
from ivit_tpu_torch.deploy.artifact import carry_linear
from ivit_tpu_torch.deploy.engine import int8_linear
from ivit_tpu_torch.deploy.swin_artifact import swin_artifact_spec, swin_artifact_to_torch, validate_swin_artifact
from ivit_tpu_torch.deploy.swin_engine import DEFAULT_KERNELS, build_swin_infer, select_swin_kernels, token_mean
from ivit_tpu_torch.deploy.swin_synthetic import swin_nonzero_probability_share, synthetic_swin_artifact
from ivit_tpu_torch.kernels import _shiftmax_common as k0
from ivit_tpu_torch.kernels import fused_int8_window_attention, fused_int8_window_attention_reference
from ivit_tpu_torch.kernels.window_attention_fused import window_attention_through_tables
from ivit_tpu_torch.models import create_config
from ivit_tpu_torch.models import swin
from tests.torch_threads import one_torch_thread  # noqa: F401

TINY = dict(img_size=16, patch_size=2, num_classes=8, embed_dim=16, depths=(2, 2), num_heads=(2, 4), window_size=4)
KERNEL_SETS = {"plain": (), "default": DEFAULT_KERNELS, "attention": ("attention",), "layernorm": ("layernorm",)}


def _images(n, size=16, seed=42):
    return np.random.default_rng(seed).standard_normal((n, size, size, 3)).astype(np.float32)


def _jax_logits(artifact, images):
    infer = jax.jit(jax_build_swin_infer(artifact, use_pallas=False))
    return {b: np.asarray(infer(jnp.asarray(images[:b]))) for b in (len(images), 1)}


@pytest.fixture(scope="module", params=[False, True], ids=["rowmax_gelu", "stable_gelu"])
def frozen(request):
    """A JAX-frozen tiny Swin, images, and the JAX engine's logits at
    batch 2 and batch 1."""
    model = SwinTransformer(**TINY, drop_path_rate=0.0, gelu_stable=request.param)
    init = jax.jit(lambda rng, x: model.init(rng, x, train=True))
    variables = init(jax.random.PRNGKey(1), jnp.asarray(_images(2, seed=0)))
    artifact = freeze_swin(model, jax.tree.map(np.asarray, variables))
    images = _images(2)
    return artifact, images, _jax_logits(artifact, images)


def _structure(tree):
    """An artifact as its schema: ``swin_artifact_spec``'s leaves."""
    if isinstance(tree, dict):
        return {k: _structure(v) for k, v in tree.items() if k != "config"}
    if isinstance(tree, list):
        return [_structure(v) for v in tree]
    if tree is None or isinstance(tree, int):
        return tree
    arr = np.asarray(tree)
    return (arr.dtype, arr.shape)


# ---- the model module's helpers -------------------------------------------


@pytest.mark.parametrize("ws", [2, 4, 7])
def test_relative_position_index_matches_jax(ws):
    np.testing.assert_array_equal(swin.relative_position_index(ws), jax_swin.relative_position_index(ws))


@pytest.mark.parametrize("geometry", [(8, 4, 2), (56, 7, 3), (14, 7, 3), (8, 4, 0)])
def test_sw_attn_mask_matches_jax(geometry):
    res, ws, shift = geometry
    ours, ref = swin.sw_attn_mask(res, res, ws, shift), jax_swin.sw_attn_mask(res, res, ws, shift)
    if shift == 0:
        assert ours is None and ref is None
    else:
        np.testing.assert_array_equal(ours, ref)
        assert ours.dtype == ref.dtype == np.float32


@pytest.mark.parametrize("ws", [2, 4])
def test_window_partition_and_reverse_match_jax(ws):
    x = np.random.default_rng(ws).integers(-128, 128, (2, 8, 8, 5)).astype(np.int8)
    windows = swin.window_partition(torch.from_numpy(x), ws)
    np.testing.assert_array_equal(windows.numpy(), np.asarray(jax_swin.window_partition(jnp.asarray(x), ws)))
    back = swin.window_reverse(windows, ws, 8, 8)
    np.testing.assert_array_equal(back.numpy(), np.asarray(jax_swin.window_reverse(jnp.asarray(windows.numpy()), ws, 8, 8)))
    np.testing.assert_array_equal(back.numpy(), x)


@pytest.mark.parametrize("name", ["swin_tiny", "swin_small", "swin_base"])
def test_config_factories_match_jax(name):
    model = getattr(jax_swin, {"swin_tiny": "swin_tiny_patch4_window7_224", "swin_small": "swin_small_patch4_window7_224",
                               "swin_base": "swin_base_patch4_window7_224"}[name])()
    expected = dict(
        img_size=model.img_size, patch_size=model.patch_size, embed_dim=model.embed_dim,
        depths=tuple(model.depths), num_heads=tuple(model.num_heads), window_size=model.window_size,
        mlp_ratio=model.mlp_ratio, num_classes=model.num_classes, gelu_stable=model.gelu_stable,
    )
    assert create_config(name) == expected


# ---- the artifact -----------------------------------------------------------


def test_spec_matches_the_frozen_artifact(frozen):
    artifact, _, _ = frozen
    validate_swin_artifact(artifact)
    assert _structure(artifact) == swin_artifact_spec(artifact["config"])
    blocks = [b for st in artifact["stages"] for b in st["blocks"]]
    assert [b["shift"] for b in blocks] == [0, 2, 0, 0]
    assert [b["mask_int"] is None for b in blocks] == [True, False, True, True]
    assert "b" not in artifact["stages"][0]["downsample"]["reduction"]


def test_artifact_to_torch_scalars(frozen):
    artifact, _, _ = frozen
    t = swin_artifact_to_torch(artifact, "cpu")
    blk = t["stages"][0]["blocks"][1]
    for key in ("r1", "rb", "scale", "r_out"):
        value = blk["attn"][key]
        assert isinstance(value, float) and float(np.float32(value)) == value
    assert blk["attn"]["mask"].shape == (4, 16, 16) and t["stages"][0]["blocks"][0]["attn"]["mask"] is None
    assert blk["attn"]["bias"].shape == (2, 16, 16)
    assert set(t["stages"][0]["downsample"]["reduction"]) == {"w", "ratio"}


def test_broken_swin_artifact_raises(frozen):
    artifact, _, _ = frozen
    stages = [dict(st, blocks=[dict(b) for b in st["blocks"]]) for st in artifact["stages"]]
    stages[0]["blocks"][1]["mask_int"] = None  # a shifted block without its mask
    with pytest.raises(ValueError, match="mask_int"):
        validate_swin_artifact(dict(artifact, stages=stages))
    stages[0]["blocks"][1]["mask_int"] = artifact["stages"][0]["blocks"][1]["mask_int"]
    stages[1]["blocks"][0]["shift"] = 2  # geometry that disagrees with the config
    with pytest.raises(ValueError, match="shift"):
        build_swin_infer(dict(artifact, stages=stages), "cpu")


# ---- the engine ---------------------------------------------------------------


@pytest.mark.parametrize("kernels", sorted(KERNEL_SETS))
def test_engine_matches_jax_engine(frozen, kernels):
    artifact, images, logits = frozen
    infer = build_swin_infer(artifact, "cpu", kernels=KERNEL_SETS[kernels])
    assert infer.kernels == frozenset(KERNEL_SETS[kernels])
    out = infer(torch.from_numpy(images)).numpy()
    assert out.shape == (2, 8) and np.all(np.isfinite(out))
    np.testing.assert_array_equal(out, logits[2])
    np.testing.assert_array_equal(infer(torch.from_numpy(images[:1])).numpy(), logits[1])


def test_synthetic_artifact_matches_freeze_schema_and_jax(frozen):
    artifact, _, _ = frozen
    stable = artifact["config"]["gelu_stable"]
    synth = synthetic_swin_artifact("swin_tiny", seed=3, gelu_stable=stable, **TINY)
    assert synth["config"] == artifact["config"]
    assert _structure(synth) == _structure(artifact)
    assert type(synth["input_scale"]) is type(artifact["input_scale"])
    images = _images(3, seed=9)
    logits = _jax_logits(synth, images)
    for kernels in ((), DEFAULT_KERNELS):
        infer = build_swin_infer(synth, "cpu", kernels=kernels)
        np.testing.assert_array_equal(infer(torch.from_numpy(images)).numpy(), logits[3])
        np.testing.assert_array_equal(infer(torch.from_numpy(images[:1])).numpy(), logits[1])
    # not degenerate: logits vary, and most window probabilities are nonzero
    assert np.std(logits[3]) > 0 and not np.allclose(logits[3][0], logits[3][1])
    shares = swin_nonzero_probability_share(synth, torch.from_numpy(images), device="cpu")
    assert len(shares) == 4 and min(shares) > 0.5, shares


def test_synthetic_artifact_is_seeded():
    a, b, c = (synthetic_swin_artifact("swin_tiny", seed=s, **TINY) for s in (5, 5, 6))
    np.testing.assert_array_equal(a["stages"][0]["blocks"][1]["bias_req"], b["stages"][0]["blocks"][1]["bias_req"])
    assert a["stages"][1]["blocks"][0]["s_bias"] == b["stages"][1]["blocks"][0]["s_bias"]
    assert not np.array_equal(a["stages"][0]["blocks"][0]["qkv"]["w"], c["stages"][0]["blocks"][0]["qkv"]["w"])
    with pytest.raises(ValueError, match="not a Swin"):
        synthetic_swin_artifact("deit_tiny")


def test_swin_tiny_schema():
    spec = swin_artifact_spec(create_config("swin_tiny"))
    blocks = [b for st in spec["stages"] for b in st["blocks"]]
    assert len(blocks) == 12 and [b["res"] for b in blocks[::2]] == [56, 28, 14, 14, 14, 7]
    assert sum(b["mask_int"] is not None for b in blocks) == 5
    assert blocks[1]["mask_int"][1] == (64, 49, 49) and blocks[11]["bias_req"][1] == (24, 49, 49)
    assert spec["stages"][2]["downsample"]["reduction"]["w"][1] == (1536, 768)
    assert spec["head"]["w"][1] == (768, 1000) and spec["patch_embed"]["w"][1] == (48, 96)


def test_token_mean_matches_jnp_mean_at_49_tokens():
    """The pool is the exact sum times float32(1/49), as ``jnp.mean``
    computes it (jitted or not); ``torch.mean`` rounds the quotient
    correctly and differs in about a quarter of the values."""
    y = np.random.default_rng(0).integers(-128, 128, (4000, 49, 16)).astype(np.int8)
    ours = token_mean(torch.from_numpy(y)).numpy()
    yf = jnp.asarray(y.astype(np.float32))
    np.testing.assert_array_equal(ours, np.asarray(jnp.mean(yf, axis=1)))
    np.testing.assert_array_equal(ours, np.asarray(jax.jit(lambda a: jnp.mean(a, axis=1))(yf)))
    plain = torch.from_numpy(y.astype(np.float32)).mean(1).numpy()
    assert 0.1 < np.mean(plain != ours) < 0.5


# ---- K7 -------------------------------------------------------------------------


def _window_case(G, N, hd, heads, n_windows, seed):
    """int8 q, k, v spread over a third of int8 scores, an integer bias, a
    mask of −100/s_bias off the diagonal, and a saturated row."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.integers(-128, 128, (G, N, hd)).astype(np.int8) for _ in range(3))
    q[0, 1], k[0] = 127, np.where(np.arange(N)[:, None] % 2 == 0, 127, -128)
    bias = rng.integers(-30, 31, (heads, N, N)).astype(np.float32)
    scale = np.float32(0.07)
    mask = np.where(rng.random((n_windows, N, N)) < 0.4, np.float32(-100.0) / scale, 0).astype(np.float32)
    for m in mask:
        np.fill_diagonal(m, 0.0)
    ratios = (np.float32(127.0 / (3 * np.sqrt(hd) * 74.0**2)), np.float32(0.9), scale, np.float32(0.05 / 128 / 0.021))
    return (q, k, v, bias, mask), tuple(float(r) for r in ratios)


def _pallas(q, k, v, bias, mask, r1, rb, scale, r_out, heads):
    """The Pallas K7 in interpret mode on N padded to 128 lanes."""
    N, npad = q.shape[1], 128

    def pad(a, axes):
        return jnp.asarray(np.pad(a, [(0, npad - s) if i in axes else (0, 0) for i, s in enumerate(a.shape)]))

    out = pallas_window_attention(
        pad(q, {1}), pad(k, {1}), pad(v, {1}), pad(bias, {1, 2}), None if mask is None else pad(mask, {1, 2}),
        r1=r1, rb=rb, scale=scale, r_out=r_out, n_valid=N, heads=heads, interpret=True,
    )
    return np.asarray(out)[:, :N]


@pytest.mark.parametrize("masked", [True, False], ids=["masked", "unmasked"])
def test_window_attention_reference_matches_pallas(masked):
    G, N, hd, heads, n_windows = 24, 16, 8, 3, 4
    (q, k, v, bias, mask), (r1, rb, scale, r_out) = _window_case(G, N, hd, heads, n_windows, seed=int(masked))
    mask = mask if masked else None
    ref = _pallas(q, k, v, bias, mask, r1, rb, scale, r_out, heads)
    args = [torch.from_numpy(a) for a in (q, k, v, bias)] + [None if mask is None else torch.from_numpy(mask)]
    ours = fused_int8_window_attention_reference(*args, r1, rb, scale, r_out, heads)
    np.testing.assert_array_equal(ours.numpy(), ref)
    assert ours.unique().numel() > 100
    # the wrapper takes the plain version for CPU tensors and counts no launch
    before = fused_int8_window_attention.launches
    np.testing.assert_array_equal(fused_int8_window_attention(*args, r1, rb, scale, r_out, heads).numpy(), ours.numpy())
    assert fused_int8_window_attention.launches == before


@pytest.mark.parametrize("rb", [0.9, 0.37, 1.7, 3.0])
def test_rb_table_matches_jax_merge(rb):
    """K7's merge table on all 256 values of a8: round(a8·rb) in float32."""
    rb = float(np.float32(rb))
    a8 = np.arange(-128, 128, dtype=np.float32)
    table = k0.rb_table(rb).numpy()
    np.testing.assert_array_equal(table[a8.astype(np.int64) & 0xFF], np.asarray(jnp.round(jnp.asarray(a8) * jnp.float32(rb))))


# softmax input scales s_bias: Swin-like ones, where every masked argument
# (the addend −100/s_bias) lies at or below the chain's clamp, a
# power-of-two 1/scale, and 0.45, where masked arguments lie above it and
# a masked score can be a row's max
WINDOW_SCALES = (0.021, 0.07, 0.2, 0.125, 0.45)


def _merged_arguments(scale):
    """Every row-max-subtracted argument K7 can meet at this scale, as
    (unmasked score, unmasked max), (masked, unmasked), (unmasked, masked)
    and (masked, masked) pairs of merged scores in [−128, 127], plus the
    float32 values at and around the clamp."""
    z = np.arange(-128, 128, dtype=np.float32)
    zm = z + np.float32(-100.0) / np.float32(scale)  # mask_int as frozen, added in f32
    pairs = [a[:, None] - b[None, :] for a in (z, zm) for b in (z, zm)]
    clamp = np.float32(k0.shift_exp_clamp(scale, 15))
    around = [clamp + np.float32(0.25) * np.arange(-40, 41, dtype=np.float32),
              np.nextafter(clamp, np.float32([-np.inf, np.inf]))]
    d = np.concatenate([p.ravel() for p in pairs] + around).astype(np.float32)
    masked_vs_unmasked = pairs[2].ravel()
    return d[d <= 0], masked_vs_unmasked[masked_vs_unmasked <= 0], clamp


@pytest.mark.parametrize("scale", WINDOW_SCALES)
def test_window_shift_exp_matches_chain(scale):
    """K7's shift-exp through its tables (K1's 256 integral entries, the
    clamp entry, the chain elsewhere) equals the chain on every argument
    it can meet, and the JAX K0 chain."""
    scale = float(np.float32(scale))
    d, masked, clamp = _merged_arguments(scale)
    ours = k0.window_shift_exp(torch.from_numpy(d), scale, 15).numpy()
    valid = np.ones(d.shape, bool)
    chain = k0.shift_exp_rows(torch.from_numpy(d), torch.tensor(scale), 15, torch.from_numpy(valid)).numpy()
    np.testing.assert_array_equal(ours, chain)
    np.testing.assert_array_equal(ours, np.asarray(jax_k0.shift_exp_rows(jnp.asarray(d), jnp.float32(scale), 15.0, jnp.asarray(valid))))
    # which path a masked score against an unmasked max takes
    if scale < 0.3:
        assert (masked <= clamp).all()
    else:
        assert (masked > clamp).any() and (masked <= clamp).any()


def _edge_window_case(scale, low, seed):
    """``_window_case`` at softmax input scale ``scale``. With ``low``, the
    rows of window 0 that have a masked column get bias 127 on it and
    ``low`` on the others: at scale 0.45 (mask −222.2, clamp −45) a low of
    −100 leaves the row max unmasked near −60 and puts the masked
    arguments near −35, above the clamp; a low of −300 clips the unmasked
    scores to −128 and makes the row max a masked score."""
    (q, k, v, bias, mask), (r1, rb, _, r_out) = _window_case(24, 16, 8, 3, 4, seed)
    mask = np.where(mask != 0, np.float32(-100.0) / np.float32(scale), np.float32(0.0)).astype(np.float32)
    if low is not None:
        hit = mask[0] != 0
        bias[:] = np.where(hit, 127.0, np.where(hit.any(-1, keepdims=True), low, bias)).astype(np.float32)
    return (q, k, v, bias, mask), (r1, rb, float(np.float32(scale)), r_out)


@pytest.mark.parametrize(
    "scale,masked,low",
    [(0.07, False, None), (0.07, True, None), (0.45, True, -100.0), (0.45, True, -300.0)],
    ids=["unmasked", "masked", "masked_above_clamp", "masked_row_max"],
)
def test_window_attention_through_tables_matches_reference_and_pallas(scale, masked, low):
    """K7's per-score path through its tables equals the plain version
    and the Pallas kernel: unmasked and masked cells, masked arguments
    above the clamp, and rows whose max is a masked score."""
    (q, k, v, bias, mask), (r1, rb, scale, r_out) = _edge_window_case(scale, low, seed=5)
    mask = mask if masked else None
    args = [torch.from_numpy(a) for a in (q, k, v, bias)] + [None if mask is None else torch.from_numpy(mask)]
    ours = window_attention_through_tables(*args, r1, rb, scale, r_out, 3).numpy()
    np.testing.assert_array_equal(ours, fused_int8_window_attention_reference(*args, r1, rb, scale, r_out, 3).numpy())
    np.testing.assert_array_equal(ours, _pallas(q, k, v, bias, mask, r1, rb, scale, r_out, 3))
    assert len(np.unique(ours)) > 20
    if not masked:
        return
    # not vacuous: the merged scores of window 0's cells (cell 0 on)
    a8 = np.clip(np.round((q.astype(np.float32) @ k.astype(np.float32).transpose(0, 2, 1)) * np.float32(r1)), -128, 127)
    z = (np.clip(np.round(a8[:3] * np.float32(rb)) + bias, -128, 127) + mask[0]).astype(np.float32)
    d = z - z.max(-1, keepdims=True)
    takes_chain = (d != np.round(d)) & (d > np.float32(k0.shift_exp_clamp(scale, 15)))
    row_max_masked = np.take_along_axis(np.broadcast_to(mask[0], z.shape), z.argmax(-1)[..., None], -1) != 0
    assert takes_chain.any() == (low is not None)
    assert row_max_masked.any() == (low is not None)


@pytest.mark.parametrize(
    "shape,heads,n_windows,match",
    [((24, 16, 8), 5, None, "multiple of heads"), ((24, 16, 8), 3, 3, "windows"),
     ((24, 16, 6), 3, None, "hd"), ((3, 257, 8), 3, None, "256")],
    ids=["heads", "windows", "hd", "tokens"],
)
def test_window_attention_rejects(shape, heads, n_windows, match):
    G, N, hd = shape
    q = torch.zeros(shape, dtype=torch.int8)
    bias = torch.zeros((heads, N, N))
    mask = None if n_windows is None else torch.zeros((n_windows, N, N))
    with pytest.raises(ValueError, match=match):
        fused_int8_window_attention(q, q, q, bias, mask, 0.1, 0.9, 0.07, 0.01, heads)


# ---- kernel selection and devices -------------------------------------------


@pytest.mark.parametrize("kernels", [("softmax",), ("gelu",), ("attention2",), ("attention", "linear_gelu")])
def test_unknown_kernel_names_raise(kernels):
    with pytest.raises(ValueError, match="unknown"):
        select_swin_kernels(create_config("swin_tiny"), kernels)


def test_attention_kernel_on_a_window_over_16_raises():
    cfg = create_config("swin_tiny", img_size=272, patch_size=4, window_size=17)  # N = 289
    with pytest.raises(ValueError, match="256"):
        select_swin_kernels(cfg, ("attention",))
    assert select_swin_kernels(cfg, ("layernorm",)) == {"layernorm"}
    assert select_swin_kernels(create_config("swin_tiny"), DEFAULT_KERNELS) == {"attention", "layernorm"}


def test_engine_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works here")
    artifact = synthetic_swin_artifact("swin_tiny", seed=5, **TINY)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_swin_infer(artifact)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        swin_nonzero_probability_share(artifact, torch.from_numpy(_images(1)))


def test_int8_linear_adds_the_bias_only_where_there_is_one():
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.integers(-128, 128, (5, 16)).astype(np.int8))
    w = torch.from_numpy(rng.integers(-128, 128, (16, 8)).astype(np.int8))
    b = torch.from_numpy(rng.integers(-1000, 1000, (8,)).astype(np.int32))
    exact = x.to(torch.int32) @ w.to(torch.int32)
    assert torch.equal(int8_linear(x, {"w": w}), exact)
    assert torch.equal(int8_linear(x, {"w": w, "b": b}), exact + b)


@pytest.mark.parametrize("K,N", [(12, 16), (384, 100), (100, 36), (16, 8)])
def test_int8_linear_at_widths_not_multiples_of_8(K, N):
    """``carry_linear`` zero-pads w to multiples of 8 (CUDA's
    ``torch._int_mm`` takes no other K or N) and keeps the true N;
    ``int8_linear`` pads x's columns to match and cuts the product back
    to N: the exact integers of the unpadded product."""
    rng = np.random.default_rng(K * N)
    layer = {"w": rng.integers(-128, 128, (K, N)).astype(np.int8), "b": rng.integers(-1000, 1000, (N,)).astype(np.int32),
             "out_scale": rng.uniform(0.5, 2.0, N).astype(np.float32)}
    carried = carry_linear(layer, "cpu", torch.tensor(np.float32(0.5)))
    assert tuple(carried["w"].shape) == (-(-K // 8) * 8, -(-N // 8) * 8)
    assert carried.get("n", N) == N and ("n" in carried) == bool(K % 8 or N % 8)
    x = torch.from_numpy(rng.integers(-128, 128, (9, K)).astype(np.int8))
    exact = x.to(torch.int32) @ torch.from_numpy(layer["w"]).to(torch.int32) + torch.from_numpy(layer["b"])
    out = int8_linear(x, carried)
    assert out.is_contiguous() and torch.equal(out, exact)
