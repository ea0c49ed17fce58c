"""Port ops ≡ JAX DEPLOY ops, bit for bit (tolerance 0), on the CPU.

Every input is made with numpy from a seed and fed to both sides; the
JAX side is ``ivit_tpu.ops`` / ``ivit_tpu.core`` in DEPLOY mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ivit_tpu.core.quantizers import weight_scale as jax_weight_scale
from ivit_tpu.ops import DEPLOY
from ivit_tpu.ops import int_layernorm as jax_int_layernorm
from ivit_tpu.ops import requantize as jax_requantize
from ivit_tpu.ops import shiftgelu as jax_shiftgelu
from ivit_tpu.ops import shiftmax as jax_shiftmax
from ivit_tpu.ops.interp import _exp2_int_fast as jax_exp2
from ivit_tpu.ops.shiftexp import int_exp_shift as jax_int_exp_shift
from ivit_tpu_torch.core import quantize, weight_scale
from ivit_tpu_torch.ops import int_exp_shift, int_layernorm, requantize, shiftgelu, shiftmax
from ivit_tpu_torch.ops.interp import exp2_int

# softmax input scales: p = |⌊−1/s⌋| from 1 to 200
SM_SCALES = (0.9, 0.31, 0.07, 0.05, 0.033, 0.0123, 0.005)
GELU_SCALES = (0.5, 0.08, 0.021, 0.0042)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _eq(torch_out, jax_out):
    np.testing.assert_array_equal(torch_out.numpy(), np.asarray(jax_out))


def _f32(x):
    return np.float32(x)


def test_exp2_int_matches_jax():
    k = np.arange(-126, 128, dtype=np.float32)
    _eq(exp2_int(_t(k)), jax_exp2(jnp.asarray(k)))


@pytest.mark.parametrize("n", [15, 23])
def test_int_exp_shift_matches_jax(n):
    rng = np.random.default_rng(n)
    q = -rng.integers(0, 600, (64,)).astype(np.float32)
    q[:3] = (0.0, -1.0, -599.0)
    for s in SM_SCALES:
        e, _ = int_exp_shift(_t(q), _t(_f32(s)), n)
        je, _ = jax_int_exp_shift(jnp.asarray(q), jnp.float32(s), n, DEPLOY)
        _eq(e, je)


@pytest.mark.parametrize("out_bits", [8, 16])
@pytest.mark.parametrize("n_cols", [17, 197, 300])
def test_shiftmax_matches_jax(out_bits, n_cols):
    """Row lengths 17 and 197 take the two-limb exact sum, 300 the
    three-limb tree; rows include ties (all equal), a saturated row, and
    a row half at its max whose exp sum passes 2^24 with low-order bits
    set (where the three-limb tree rounds twice and a plain f32 sum
    rounds elsewhere)."""
    rng = np.random.default_rng(out_bits * 1000 + n_cols)
    q = rng.integers(-128, 128, (6, n_cols)).astype(np.float32)
    q[0] = 5.0  # tied scores
    q[1, ::2], q[1, 1::2] = 127.0, -128.0  # saturated
    q[2, : n_cols // 2] = 127.0  # exp sum past 2^24
    for s in SM_SCALES:
        out, s_out = shiftmax(_t(q), _t(_f32(s)), out_bits=out_bits)
        jout, js_out = jax_shiftmax(jnp.asarray(q), jnp.float32(s), out_bits=out_bits, interp=DEPLOY)
        _eq(out, jout)
        assert float(s_out) == float(js_out)


@pytest.mark.parametrize("n_cols", [17, 197, 300])
def test_exact_row_sum_matches_jax(n_cols):
    """The row sum itself, whose rounding the Shiftmax output only shows
    where ⌊(2^31−1)/Σ⌋ crosses an integer: two limbs up to 256 columns,
    the twice-rounding three-limb tree above."""
    from ivit_tpu.ops.shiftmax import _exact_sum_lastdim as jax_sum
    from ivit_tpu_torch.ops.shiftmax import _exact_sum_lastdim

    rng = np.random.default_rng(n_cols)
    q = rng.integers(-128, 128, (4, n_cols)).astype(np.float32)
    q[1, : n_cols // 2] = 127.0
    q = q - q.max(-1, keepdims=True)
    for s in SM_SCALES:
        e, _ = int_exp_shift(_t(q), _t(_f32(s)), 15)
        _eq(_exact_sum_lastdim(e), jax_sum(jnp.asarray(e.numpy()), DEPLOY))


@pytest.mark.parametrize("stable", [True, False], ids=["stable", "rowmax"])
def test_shiftgelu_matches_jax(stable):
    """Includes an all-negative row (the row-max form's saturating
    e^(−max) case) and an all-zero row."""
    rng = np.random.default_rng(int(stable))
    q = rng.integers(-128, 128, (5, 96)).astype(np.float32)
    q[0] = -rng.integers(1, 129, 96)  # all negative
    q[1] = 0.0
    for s in GELU_SCALES:
        out, s_out = shiftgelu(_t(q), _t(_f32(s)), out_bits=8, stable=stable)
        jout, js_out = jax_shiftgelu(jnp.asarray(q), jnp.float32(s), out_bits=8, interp=DEPLOY, stable=stable)
        _eq(out, jout)
        assert float(s_out) == float(js_out)


@pytest.mark.parametrize("C", [128, 1024], ids=["merged_stats", "split_stats"])
def test_int_layernorm_matches_jax(C):
    """C = 128 takes the merged a²/ab accumulator, C = 1024 the split one;
    rows include zero variance and the int16 extremes."""
    rng = np.random.default_rng(C)
    q = rng.integers(-(2**15), 2**15, (6, C)).astype(np.float32)
    q[0] = 17.0  # zero variance
    q[1] = 0.0
    q[2, ::2], q[2, 1::2] = 32767.0, -32768.0
    q[3] = rng.integers(-40, 40, C)  # small variance
    gamma = (1.0 + 0.1 * rng.standard_normal(C)).astype(np.float32)
    beta = (0.05 * rng.standard_normal(C)).astype(np.float32)
    out, s_out = int_layernorm(_t(q), _t(gamma), _t(beta))
    jout, js_out = jax_int_layernorm(jnp.asarray(q), jnp.asarray(gamma), jnp.asarray(beta), interp=DEPLOY)
    _eq(out, jout)
    _eq(s_out, js_out)
    # an int16 carrier gives the same result as the float32 one
    _eq(int_layernorm(_t(q.astype(np.int16)), _t(gamma), _t(beta))[0], jout)


@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("residual", [False, True], ids=["plain", "residual"])
def test_requantize_matches_jax(bits, residual):
    rng = np.random.default_rng(bits + residual)
    q = rng.integers(-(2**24), 2**24, (8, 48)).astype(np.float32)
    s_in = (rng.uniform(0.5, 2.0, 48) * 1e-6).astype(np.float32)
    s_out = np.float32(0.0173)
    kw, jkw = {}, {}
    if residual:
        idq = rng.integers(-(2**15), 2**15, (8, 48)).astype(np.float32)
        ids = np.float32(3.1e-3)
        kw = dict(identity_q=_t(idq), identity_scale=_t(ids))
        jkw = dict(identity_q=jnp.asarray(idq), identity_scale=jnp.float32(ids))
    out = requantize(_t(q), _t(s_in), _t(s_out), bits, **kw)
    jout = jax_requantize(jnp.asarray(q), jnp.asarray(s_in), jnp.float32(s_out), bits, interp=DEPLOY, **jkw)
    _eq(out, jout)


def test_weight_scale_and_quantize_match_jax():
    from ivit_tpu.core.ste import quantize as jax_quantize

    rng = np.random.default_rng(7)
    w = (0.02 * rng.standard_normal((64, 24))).astype(np.float32)
    s = weight_scale(_t(w).T, 8)
    js = jax_weight_scale(jnp.asarray(w).T, 8)
    _eq(s, js)
    _eq(quantize(_t(w), s, 8), jax_quantize(jnp.asarray(w), js, 8))
