"""K10, the fused attention over rows of 257 to 1,024 tokens, on the CPU:
its plain version (the kernel's arithmetic: a table lookup a score, the
three limb sums, the spec's float32 tree) against K1's plain version,
whose ``ops.shiftmax`` takes the spec's three-limb sum above 256 columns;
the engine's route to it; and the port's engine at 290 tokens against
the JAX engine, which runs XLA ops there. The kernel itself runs on the
card (``tests/test_torch_cuda.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ivit_tpu.deploy import build_vit_infer as jax_build_vit_infer
from ivit_tpu.deploy import freeze_vit
from ivit_tpu.models import VisionTransformer
from ivit_tpu_torch.deploy import engine
from ivit_tpu_torch.deploy.engine import attention_wrapper, build_vit_infer, select_kernels
from ivit_tpu_torch.kernels import (
    WRAPPERS,
    fused_int8_attention,
    fused_int8_attention_long,
    fused_int8_attention_long_reference,
    fused_int8_attention_reference,
)
from ivit_tpu_torch.kernels._shiftmax_common import shift_exp_table
from ivit_tpu_torch.kernels.attention_fused import SHIFTMAX_N
from ivit_tpu_torch.kernels.attention_long import limb_tree_sum
from ivit_tpu_torch.ops.shiftmax import _exact_sum_lastdim

@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these small float64 products and elementwise
    chains run tens of times slower split over contended cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# (r1, softmax input scale): small, middling and large shift-exps; at
# 1/600 one score at the row max alone is 1200·2^14 > 2^24
RATIOS = [(1 / 2000.0, 1 / 40.0), (1 / 400.0, 1 / 8.0), (1 / 100.0, 1 / 300.0), (1e-5, 1 / 600.0)]


def _qkv(N, G=3, hd=64, seed=0):
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randint(-128, 128, (G, N, hd), generator=g, dtype=torch.int8) for _ in range(3))
    k[1] = k[1, :1].clone()  # cell 1: every key the same, so every row all-equal
    q[2] = 0  # cell 2: every score 0
    return q, k, v


@pytest.mark.parametrize("N", [257, 290, 577, 1024])
def test_plain_k10_equals_k1_plain_version(N):
    q, k, v = _qkv(N)
    for r1, scale in RATIOS:
        for bits in (8, 16):
            want = fused_int8_attention_reference(q, k, v, r1, scale, 1 / 300.0, bits)
            got = fused_int8_attention_long_reference(q, k, v, r1, scale, 1 / 300.0, bits)
            assert torch.equal(got, want), (r1, scale, bits)
    # the wrapper runs the plain version on the CPU, through its operator
    assert torch.equal(fused_int8_attention_long(q, k, v, *RATIOS[0], 1 / 300.0),
                       fused_int8_attention_reference(q, k, v, *RATIOS[0], 1 / 300.0))


def edge_qkv(N: int, hd: int = 64):
    """Three cells whose every row's exp sum passes 2^24 at ``EDGE``
    (r1 = 1, scale 1/3: the row max's shift-exp is 3·2^15, that of the max
    − 31 is small): cell 0 all-equal rows (every score 100), cell 1 rows
    whose last 177 scores are 69 and the rest 100 (a sum past 2^24 whose
    low bits float32 rounds away), cell 2 the same with the low keys
    first."""
    q = torch.ones((3, N, hd), dtype=torch.int8)
    high = torch.tensor([2] * 36 + [1] * 28, dtype=torch.int8)  # q·k = 100
    low = torch.tensor([2] * 5 + [1] * 59, dtype=torch.int8)  # q·k = 69
    k = high[:hd].repeat(3, N, 1)
    k[1, N - LOW:] = low[:hd]
    k[2, :LOW] = low[:hd]
    v = torch.randint(-128, 128, (3, N, hd), generator=torch.Generator().manual_seed(N), dtype=torch.int8)
    return q, k, v


EDGE = (1.0, 1 / 3.0)
LOW = 177


@pytest.mark.parametrize("N", [577, 1024])
def test_plain_k10_at_rows_whose_sum_rounds(N):
    q, k, v = edge_qkv(N)
    for bits in (8, 16):
        want = fused_int8_attention_reference(q, k, v, *EDGE, 1 / 300.0, bits)
        assert torch.equal(fused_int8_attention_long_reference(q, k, v, *EDGE, 1 / 300.0, bits), want)
    # the sums: past 2^24, and cell 1's not a float32 value
    e = [int(x) for x in shift_exp_table(EDGE[1], SHIFTMAX_N)]
    sums = (N * e[0], (N - LOW) * e[0] + LOW * e[31])
    assert all(s > 2**24 for s in sums) and int(np.float32(sums[1])) != sums[1]


@pytest.mark.parametrize("N", [257, 577, 1024])
def test_limb_tree_is_the_spec_tree_where_sums_pass_2_24(N):
    """Rows whose exp sum passes 2^24 and rounds, rows past 2^31 (the
    clip's side) and all-equal rows: the kernel's integer limb sums and
    tree equal ``ops.shiftmax``'s float32 limbs and tree bit for bit."""
    g = torch.Generator().manual_seed(N)
    rows = []
    for scale in (1 / 600.0, 1 / 40.0, 1 / 3.0):
        table = shift_exp_table(scale, SHIFTMAX_N)
        idx = torch.randint(0, 256, (16, N), generator=g)
        idx[:4] = torch.randint(0, 3, (4, N), generator=g)  # most entries near the max: large sums
        idx[4] = 0  # all-equal at the max
        idx[5] = 255  # all-equal at the least entry
        idx[6:10, : N // 2] = 0  # half at the max, half far below: odd low bits
        idx[6:10, N // 2:] = torch.randint(24, 64, (4, N - N // 2), generator=g)
        rows.append(table[idx])
    odd = torch.full((1, N), float(shift_exp_table(1 / 40.0, SHIFTMAX_N)[0]))
    odd[0, -1] = 3.0  # 1.31e6·(N − 1) + 3: past 2^24, its low bits rounded away
    e = torch.cat(rows + [odd])
    got, want = limb_tree_sum(e), _exact_sum_lastdim(e)
    assert torch.equal(got, want)
    exact = e.to(torch.float64).sum(-1, keepdim=True)
    assert ((exact > 2**24) & (exact < 2**31)).sum() >= 10 and (exact > 2**31).any()
    assert ((want.to(torch.float64) != exact) & (exact < 2**31)).any()  # some row rounds below the clip


@pytest.mark.parametrize("hd", [4, 48])
def test_plain_k10_at_other_head_dims(hd):
    q, k, v = _qkv(577, hd=hd, seed=hd)
    for r1, scale in RATIOS:
        assert torch.equal(fused_int8_attention_long_reference(q, k, v, r1, scale, 1 / 200.0),
                           fused_int8_attention_reference(q, k, v, r1, scale, 1 / 200.0))


@pytest.mark.parametrize("shape", [(2, 256, 64), (2, 1025, 64), (2, 577, 68), (2, 577, 62)])
def test_k10_refuses_outside_its_domain(shape):
    q = torch.zeros(shape, dtype=torch.int8)
    with pytest.raises(ValueError, match="need G >= 1"):
        fused_int8_attention_long(q, q, q, 1.0, 1.0, 1.0)


def _cfg(img_size, **kw):
    cfg = dict(img_size=img_size, patch_size=16, embed_dim=1024, depth=24, num_heads=16, mlp_ratio=4.0,
               num_classes=1000, softmax_bits=8, gelu_stable=True)
    return dict(cfg, **kw)


@pytest.mark.parametrize("img_size, tokens", [(384, 577), (272, 290), (512, 1025)])
def test_attention_over_256_tokens_selects_k10(img_size, tokens):
    cfg = _cfg(img_size)
    assert (cfg["img_size"] // 16) ** 2 + 1 == tokens
    if tokens > 1024:
        with pytest.raises(ValueError, match="K10's bound of 1024"):
            select_kernels(cfg)
        return
    assert select_kernels(cfg) == {"attention", "layernorm", "gelu_stable"}
    assert attention_wrapper(tokens) is WRAPPERS["K10"] is fused_int8_attention_long


@pytest.mark.parametrize("img_size, patch_size, embed_dim, num_heads", [
    (224, 14, 1280, 16),  # ViT-H/14: 257 tokens, head dim 80
    (384, 16, 1000, 20),  # head dim 50, not a multiple of 4
])
def test_attention_over_256_tokens_outside_k10_head_dims_raises(img_size, patch_size, embed_dim, num_heads):
    cfg = _cfg(img_size, patch_size=patch_size, embed_dim=embed_dim, num_heads=num_heads)
    with pytest.raises(ValueError, match="K10"):
        select_kernels(cfg)
    assert "attention" not in select_kernels(cfg, ("layernorm",))


@pytest.mark.parametrize("tokens", [197, 256, 50, 1])
def test_attention_up_to_256_tokens_stays_on_k1(tokens):
    assert attention_wrapper(tokens) is WRAPPERS["K1"] is fused_int8_attention
    assert select_kernels(_cfg(224)) == {"attention", "layernorm", "gelu_stable"}


@pytest.mark.parametrize("kernels", [("attention2",), ("softmax",), ("attention2", "layernorm")])
def test_attention2_and_softmax_still_raise_over_256_tokens(kernels):
    with pytest.raises(ValueError, match="256"):
        select_kernels(_cfg(384, softmax_bits=16, gelu_stable=False), kernels)


# the small model over 256 tokens: img 272, patch 16 (290 tokens), embed 64, 2 heads, depth 2
LONG = dict(img_size=272, patch_size=16, embed_dim=64, depth=2, num_heads=2)


def _images(n, seed=42):
    return np.random.default_rng(seed).standard_normal((n, LONG["img_size"], LONG["img_size"], 3)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_long():
    """The frozen model, two images and the JAX engine's logits."""
    model = VisionTransformer(**LONG, softmax_bits=8, gelu_stable=True)
    variables = jax.jit(lambda rng, x: model.init(rng, x, train=True))(jax.random.PRNGKey(3), jnp.asarray(_images(2, 0)))
    artifact = freeze_vit(model, jax.tree.map(np.asarray, variables))
    images = _images(2)
    return artifact, images, np.asarray(jax_build_vit_infer(artifact, use_pallas=False)(jnp.asarray(images)))


@pytest.mark.parametrize("kernels", [(), ("attention", "layernorm")], ids=["plain", "defaults"])
def test_engine_over_256_tokens_matches_jax_engine(jax_long, kernels, monkeypatch):
    artifact, images, want = jax_long
    calls = []
    monkeypatch.setattr(engine, "fused_int8_attention_long",
                        lambda *a: calls.append(a[0].shape) or fused_int8_attention_long(*a))
    infer = build_vit_infer(artifact, "cpu", kernels=kernels)
    got = infer(torch.from_numpy(images)).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.all(np.isfinite(got)) and np.abs(got).max() > 0
    # the defaults send each block's attention to K10, the plain path none
    assert calls == ([(2 * LONG["num_heads"], 290, 32)] * LONG["depth"] if kernels else [])
