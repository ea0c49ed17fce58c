"""K9 (``kernels.fused_requant_stable_gelu``), the fc1 epilogue of the
stable-GELU engine as one table lookup an element, on the CPU, tolerance 0:

* its table (``kernels.stable_gelu_table``) equals JAX's
  ``shiftgelu(stable=True)`` followed by the engine's requant on all 256
  int8 inputs, from a very small to a very large GELU input scale;
* its wrapper, which runs the plain version on CPU tensors, equals the
  plain chain ``deploy.engine._mlp_hidden`` runs with ``kernels=()``
  (int32 bias add, requant, stable ShiftGELU, requant), at the DeiT-S
  path's shapes, a ragged M and an odd C, on accumulators above 2^24
  (where the conversion to float32 rounds), bias adds that wrap, and
  inputs that clip at both ends of int8;
* the engine selects it for stable-GELU models whenever any kernel is
  asked for, refuses it by name for row-max models, and leaves
  ``kernels=()`` plain.

The kernel itself runs only on a GPU: ``tests/test_torch_cuda.py``.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ivit_tpu.ops import DEPLOY
from ivit_tpu.ops import shiftgelu as jax_shiftgelu
from ivit_tpu_torch.deploy.engine import _mlp_hidden, select_kernels
from ivit_tpu_torch.kernels import fused_requant_stable_gelu, fused_requant_stable_gelu_reference, stable_gelu_table
from ivit_tpu_torch.ops import INT8, requant, shiftgelu
from tests.torch_threads import one_torch_thread  # noqa: F401

# (GELU input scale, output ratio): a very small scale (the shift-exp's
# p·2^n far above 2^31), DeiT-like ones, a scale whose −1/(1.702·s) is
# above −1 (p = 1), and ratios from all-clipping to barely-moving outputs
TABLE_SCALES = [(1e-4, 0.02), (0.0021, 0.9), (0.031, 0.7), (0.06, 0.25), (0.4, 1.3), (1.9, 0.05), (40.0, 0.011)]


def _f32(v):
    return torch.tensor(np.float32(v))


def _jax_table(s, r, static_p=None):
    q = jnp.arange(-128, 128, dtype=jnp.float32)
    g, _ = jax_shiftgelu(q, jnp.float32(s), out_bits=8, interp=DEPLOY, stable=True, static_p=static_p)
    # the JAX engine's _requant
    return np.asarray(jnp.clip(jnp.round(g * jnp.float32(r)), -128, 127).astype(jnp.int8))


@pytest.mark.parametrize("s,r", TABLE_SCALES, ids=[f"s{s}_r{r}" for s, r in TABLE_SCALES])
def test_table_matches_jax_stable_shiftgelu(s, r):
    table = stable_gelu_table(_f32(s), _f32(r))
    assert table.dtype == torch.int8 and table.shape == (256,)
    np.testing.assert_array_equal(table.numpy(), _jax_table(s, r))
    # the JAX engine passes the frozen scale's p as static_p (value-identical guard elisions)
    np.testing.assert_array_equal(table.numpy(), _jax_table(s, r, static_p=math.ceil(1.0 / (1.702 * s))))


def _plain_chain(x, b, r1, scale, ratio):
    """``_mlp_hidden``'s plain path after the GEMM: int8_linear's bias
    add, the fc1 requant, the stable ShiftGELU and the requant."""
    g, _ = shiftgelu(requant(x + b, r1, *INT8), scale, out_bits=8, stable=True)
    return requant(g, ratio, *INT8).to(torch.int8)


def _accumulators(M, C, seed):
    """int32 fc1 accumulators, a bias and per-channel ratios: most q
    spread over int8; every seventh channel above 2^24 in |x + b| (odd,
    so the float32 conversion rounds) at a ratio that keeps it in range;
    row 1 clipping at +127, row 2 at −128; channel 3's bias wrapping."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-(2**20), 2**20, (M, C)).astype(np.int32)
    b = rng.integers(-(2**16), 2**16, (C,)).astype(np.int32)
    r1 = (rng.uniform(0.5, 2.0, (C,)) * 1e-4).astype(np.float32)
    x[:, ::7] = rng.integers(-(2**27), 2**27, (M, len(range(0, C, 7)))) | 1
    b[::7] = 0
    r1[::7] = np.float32(9e-7)
    if M > 2:
        x[1], x[2] = 2**30, -(2**30)
    if C > 3:
        b[3] = 2**31 - 1
        x[:, 3] = np.abs(x[:, 3]) + 1  # x + b wraps to negative
    return torch.from_numpy(x), torch.from_numpy(b), torch.from_numpy(r1)


@pytest.mark.parametrize("shape", [(25216, 1536), (197, 1536), (1003, 1536), (5, 99)],
                         ids=["batch128", "batch1", "ragged_m", "odd_c"])
def test_wrapper_on_cpu_equals_plain_chain(shape):
    M, C = shape
    x, b, r1 = _accumulators(M, C, seed=M + C)
    scale, ratio = _f32(0.031), _f32(0.008)  # a DeiT-like output ratio s_in / 2^7 / s_out
    table = stable_gelu_table(scale, ratio)
    before = fused_requant_stable_gelu.launches
    got = fused_requant_stable_gelu(x, b, r1, table)
    assert fused_requant_stable_gelu.launches == before  # the CPU runs the plain version: no launch
    want = _plain_chain(x, b, r1, scale, ratio)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert want.unique().numel() > (100 if M > 100 else 20)
    torch.testing.assert_close(fused_requant_stable_gelu_reference(x, b, r1, table), want, rtol=0, atol=0)
    # the cases the accumulators are built to reach
    acc = (x + b).to(torch.int64)
    q = requant(x + b, r1, *INT8)
    big = acc.abs() > 2**24
    assert big.any() and (acc.to(torch.float32).to(torch.int64) != acc)[big].any()
    if M > 2:
        assert (q[1, 1::7] == 127).all() and (q[2, 1::7] == -128).all()
    if C > 3:
        assert ((x[:, 3].to(torch.int64) + int(b[3])) > 2**31 - 1).all() and (acc[:, 3] < 0).all()


def _block(K, C, seed, rank_shard=False):
    """A carried block's fc1 and GELU at a tiny K: a real GEMM feeds the
    chain; ``rank_shard`` gives fc1 a tensor-parallel ``reduce`` (the
    identity here), before which K9 must not add the bias."""
    rng = np.random.default_rng(seed)
    w = torch.from_numpy(rng.integers(-128, 128, (K, C)).astype(np.int8))
    b = rng.integers(-(2**15), 2**15, (C,)).astype(np.int32)
    b[0], b[1] = 2**30, -(2**30)  # channel 0 clips at +127, channel 1 at −128
    b = torch.from_numpy(b)
    ratio = torch.from_numpy((rng.uniform(0.5, 2.0, (C,)) * 1.5e-3).astype(np.float32))
    scale, gratio = _f32(0.031), _f32(0.7)
    fc1 = {"w": w, "b": b, "ratio": ratio}
    if rank_shard:
        fc1["reduce"] = lambda acc: acc
    gelu = {"scale": scale, "ratio": gratio, "table": stable_gelu_table(scale, gratio)}
    return {"fc1": fc1, "gelu": gelu}


@pytest.mark.parametrize("rank_shard", [False, True], ids=["whole", "reduced_shard"])
def test_mlp_hidden_through_k9_equals_plain(rank_shard):
    y = torch.from_numpy(np.random.default_rng(1).integers(-128, 128, (37, 64)).astype(np.int8))
    blk = _block(64, 96, seed=2, rank_shard=rank_shard)
    cfg = {"gelu_stable": True}
    got = _mlp_hidden(y, blk, cfg, frozenset({"gelu_stable"}))
    want = _mlp_hidden(y, blk, cfg, frozenset())
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    q = requant(torch.matmul(y.to(torch.int64), blk["fc1"]["w"].to(torch.int64)) + blk["fc1"]["b"],
                blk["fc1"]["ratio"], *INT8)
    assert (q[:, 0] == 127).all() and (q[:, 1] == -128).all() and len(q[:, 2:].unique()) > 100


def _cfg(**kw):
    cfg = dict(img_size=224, patch_size=16, embed_dim=384, depth=12, num_heads=6,
               mlp_ratio=4.0, num_classes=1000, softmax_bits=8, gelu_stable=True)
    cfg.update(kw)
    return cfg


@pytest.mark.parametrize(
    "cfg,kernels,expected",
    [
        (_cfg(), ("attention", "layernorm"), {"attention", "layernorm", "gelu_stable"}),
        (_cfg(), ("layernorm",), {"layernorm", "gelu_stable"}),
        (_cfg(), ("gelu_stable",), {"gelu_stable"}),
        (_cfg(), ("attention", "gelu_stable"), {"attention", "gelu_stable"}),
        (_cfg(), (), set()),
        (_cfg(gelu_stable=False, softmax_bits=16), ("attention", "layernorm"), {"attention", "layernorm"}),
        (_cfg(gelu_stable=False, softmax_bits=16), (), set()),
        (_cfg(gelu_stable=False), ("gelu_stable",), "gelu_stable=False"),
        (_cfg(gelu_stable=False), ("layernorm", "gelu_stable"), "gelu_stable=False"),
    ],
    ids=["default", "any_kernel", "named", "named_with_others", "plain", "rowmax", "rowmax_plain",
         "named_for_rowmax", "named_with_others_for_rowmax"],
)
def test_selection(cfg, kernels, expected):
    if isinstance(expected, str):
        with pytest.raises(ValueError, match=expected):
            select_kernels(cfg, kernels)
    else:
        assert select_kernels(cfg, kernels) == expected


@pytest.mark.parametrize("case", ["int8_input", "three_dims", "b_shape", "b_dtype", "r1_shape", "table_shape",
                                  "table_dtype", "table_device", "non_contiguous", "empty"])
def test_wrapper_rejects(case):
    x, b, r1, table = (torch.zeros((4, 16), dtype=torch.int32), torch.zeros(16, dtype=torch.int32), torch.ones(16),
                       torch.zeros(256, dtype=torch.int8))
    if case == "int8_input":
        x = x.to(torch.int8)
    elif case == "three_dims":
        x = x.reshape(2, 2, 16)
    elif case == "b_shape":
        b = torch.zeros(15, dtype=torch.int32)
    elif case == "b_dtype":
        b = b.to(torch.int64)
    elif case == "r1_shape":
        r1 = torch.ones(15)
    elif case == "table_shape":
        table = torch.zeros(255, dtype=torch.int8)
    elif case == "table_dtype":
        table = table.to(torch.uint8)
    elif case == "table_device":
        table = table.to("meta")
    elif case == "non_contiguous":
        x = torch.zeros((16, 4), dtype=torch.int32).T
    elif case == "empty":
        x = torch.zeros((0, 16), dtype=torch.int32)
    with pytest.raises(ValueError):
        fused_requant_stable_gelu(x, b, r1, table)
