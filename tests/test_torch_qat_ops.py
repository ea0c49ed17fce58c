"""The port's QAT (SIM) ops against JAX's SIM ops on the CPU.

Forward values are held bit-equal (tolerance 0); gradients at JAX's own
bounds for its SIM ops against the reference (rtol 2e-5 with atol 1e-7
to 1e-6, ``tests/test_ref_grad_differential.py``): the backward sums in
float32 in other orders. The JAX side runs op by op, as its own op tests
do. Inputs are made with numpy from a seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ivit_tpu.core.quantizers import symmetric_scale as jax_symmetric_scale
from ivit_tpu.core.ste import floor_ste as jax_floor_ste
from ivit_tpu.core.ste import quantize as jax_quantize
from ivit_tpu.core.ste import round_ste as jax_round_ste
from ivit_tpu.nn.quant import exact_int8_dot as jax_exact_int8_dot
from ivit_tpu.nn.quant import exact_int8_dot_bias as jax_exact_int8_dot_bias
from ivit_tpu.nn.quant import exact_int_matmul_8x8 as jax_mm_8x8
from ivit_tpu.nn.quant import exact_int_matmul_16x8 as jax_mm_16x8
from ivit_tpu.ops import SIM as JSIM
from ivit_tpu.ops import int_layernorm as jax_int_layernorm
from ivit_tpu.ops import requantize as jax_requantize
from ivit_tpu.ops import shiftgelu as jax_shiftgelu
from ivit_tpu.ops import shiftmax as jax_shiftmax
from ivit_tpu.ops.shiftexp import int_exp_shift as jax_int_exp_shift
from ivit_tpu_torch.core import QTensor, floor_ste, quantize, round_ste, symmetric_scale
from ivit_tpu_torch.nn.quant import exact_int8_dot, exact_int8_dot_bias, exact_int_matmul, quant_matmul
from ivit_tpu_torch.ops import int_exp_shift, int_layernorm, requantize, shiftgelu, shiftmax
from ivit_tpu_torch.ops.interp import SIM
from ivit_tpu_torch.ops.intmm import int8_matmul
from tests.torch_threads import one_torch_thread  # noqa: F401

RTOL, ATOL = 2e-5, 1e-7  # tests/test_ref_grad_differential.py:139, 171
# The products' gradients are float32 matmuls summed in other orders: an
# entry that cancels is held to 1e-6 of the largest, not to its own size.


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _eq(torch_out, jax_out):
    np.testing.assert_array_equal(torch_out.detach().numpy(), np.asarray(jax_out))


def _grads(fn, args, w):
    """d(Σ fn(args)·w) by torch autograd, for every argument."""
    out = fn(*args)
    return torch.autograd.grad((out * _t(w)).sum(), args, allow_unused=True, materialize_grads=True)


def _jax_grads(fn, args, w):
    argnums = tuple(range(len(args)))
    return jax.grad(lambda *a: jnp.sum(fn(*a) * jnp.asarray(w)), argnums=argnums)(*map(jnp.asarray, args))


def _close(g, jg, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(g.detach().numpy(), np.asarray(jg), rtol=rtol, atol=atol)


def test_round_and_floor_ste_match_jax():
    x = np.random.default_rng(0).normal(0, 40, 257).astype(np.float32)
    x[:4] = (0.5, 1.5, -2.5, -0.5)  # ties round to even
    w = np.random.default_rng(1).normal(size=x.shape).astype(np.float32)
    for ours, theirs in ((round_ste, jax_round_ste), (floor_ste, jax_floor_ste)):
        xt = _t(x, True)
        _eq(ours(xt), theirs(jnp.asarray(x)))
        (g,) = _grads(ours, (xt,), w)
        _eq(g, _jax_grads(theirs, (x,), w)[0])  # identity: g == w


@pytest.mark.parametrize("bits", [8, 16, 32])
def test_quantize_matches_jax(bits):
    """Value, and the gradient 1/scale everywhere (clamped entries too)."""
    rng = np.random.default_rng(bits)
    scale = np.float32(0.013)
    x = rng.normal(0, 1.5 * scale * 2 ** (bits - 1), (9, 33)).astype(np.float32)
    x[0, :3] = (1e30, -1e30, 0.5 * scale)
    w = rng.normal(size=x.shape).astype(np.float32)
    xt = _t(x, True)
    _eq(quantize(xt, _t(scale), bits), jax_quantize(jnp.asarray(x), jnp.float32(scale), bits))
    (g,) = _grads(lambda v: quantize(v, _t(scale), bits), (xt,), w)
    _eq(g, _jax_grads(lambda v: jax_quantize(v, jnp.float32(scale), bits), (x,), w)[0])


def test_sim_exp2_matches_jax():
    """Forward the exact 2^k; gradient (g·ln2)·2^k, as JAX's custom_vjp.
    From k = −100: below, the gradient is subnormal, which XLA's CPU
    flushes to zero (the chains reach k ≥ −1 only)."""
    k = np.arange(-100, 128, dtype=np.float32)
    w = np.random.default_rng(2).normal(size=k.shape).astype(np.float32)
    kt = _t(k, True)
    _eq(SIM.exp2(kt), JSIM.exp2(jnp.asarray(k)))
    (g,) = _grads(SIM.exp2, (kt,), w)
    _eq(g, _jax_grads(JSIM.exp2, (k,), w)[0])


def test_sim_clip_keeps_value_far_above_hi():
    """The residue form at |x| ≫ hi: shift-exp of a large positive input
    reaches x ≈ 1.2e18, where ``x + sg(clip − x)`` would give 0."""
    x = np.array([1.2e18, -1.2e18, 3.0, 2.0**31 + 2.0**8], np.float32)
    w = np.arange(1, 5, dtype=np.float32)
    lo, hi = 0.0, 2.0**31 - 1.0
    xt = _t(x, True)
    out = SIM.clip(xt, lo, hi)
    _eq(out, JSIM.clip(jnp.asarray(x), lo, hi))
    assert out[0].item() == 2.0**31 and out[1].item() == 0.0
    (g,) = _grads(lambda v: SIM.clip(v, lo, hi), (xt,), w)
    _eq(g, w)


@pytest.mark.parametrize("n", [15, 23])
def test_sim_int_exp_shift_matches_jax(n):
    rng = np.random.default_rng(n)
    q = -rng.integers(0, 600, (64,)).astype(np.float32)
    q[:3] = (0.0, -1.0, -599.0)
    w = rng.normal(size=q.shape).astype(np.float32)
    for s in (0.31, 0.05, 0.0123):
        qt = _t(q, True)
        e, _ = int_exp_shift(qt, _t(np.float32(s)), n, SIM)
        je, _ = jax_int_exp_shift(jnp.asarray(q), jnp.float32(s), n, JSIM)
        _eq(e, je)
        (g,) = _grads(lambda v: int_exp_shift(v, _t(np.float32(s)), n, SIM)[0], (qt,), w)
        jg = _jax_grads(lambda v: jax_int_exp_shift(v, jnp.float32(s), n, JSIM)[0], (q,), w)[0]
        _close(g, jg, atol=1e-6 * float(np.abs(jg).max()))


@pytest.mark.parametrize("n_cols", [17, 197, 300])
@pytest.mark.parametrize("out_bits", [8, 16])
def test_sim_shiftmax_matches_jax(out_bits, n_cols):
    """Rows of 17 and 197 take the two-limb exact sum, 300 the three-limb
    one; row 0 holds tied maxima (the max's gradient is split evenly on
    both sides)."""
    rng = np.random.default_rng(out_bits * 1000 + n_cols)
    q = rng.integers(-128, 128, (3, 5, n_cols)).astype(np.float32)
    q[0, 0, :4] = 127.0
    w = rng.normal(size=q.shape).astype(np.float32)
    for s in (2.0**-4, 0.033):
        s = np.float32(s)

        def ours(v):
            o, so = shiftmax(v, _t(s), out_bits=out_bits, interp=SIM)
            return o * so

        def theirs(v):
            o, so = jax_shiftmax(v, jnp.float32(s), out_bits=out_bits, interp=JSIM)
            return o * so

        qt = _t(q, True)
        _eq(ours(qt), theirs(jnp.asarray(q)))
        (g,) = _grads(ours, (qt,), w)
        _close(g, _jax_grads(theirs, (q,), w)[0])


@pytest.mark.parametrize("stable", [False, True], ids=["rowmax", "stable"])
def test_sim_shiftgelu_matches_jax(stable):
    """Row 0 is all negative (the row-max form's saturating e^(−max)),
    row 1 has tied maxima; the output scale carries the input scale's
    gradient, the sigmoid's scale none."""
    rng = np.random.default_rng(7 + stable)
    q = rng.integers(-128, 128, (4, 9, 32)).astype(np.float32)
    q[0, 0] = -rng.integers(60, 128, 32)
    q[0, 1, :3] = 127.0
    w = rng.normal(size=q.shape).astype(np.float32)
    for s in (2.0**-4, 0.021):
        s = np.float32(s)

        def ours(v, sc):
            o, so = shiftgelu(v, sc, out_bits=8, stable=stable, interp=SIM)
            return o * so

        def theirs(v, sc):
            o, so = jax_shiftgelu(v, sc, out_bits=8, interp=JSIM, stable=stable)
            return o * so

        qt, st = _t(q, True), _t(s, True)
        _eq(ours(qt, st), theirs(jnp.asarray(q), jnp.float32(s)))
        g, gs = _grads(ours, (qt, st), w)
        jg, jgs = _jax_grads(theirs, (q, s), w)
        _close(g, jg)
        _close(gs, jgs, rtol=1e-5)


def test_sim_int_layernorm_matches_jax():
    """Values through the exact statistics; dq through the float twin of
    mean and variance, dγ through the live output scale, dβ none."""
    d = 64
    rng = np.random.default_rng(3)
    gamma = rng.normal(1.0, 0.1, d).astype(np.float32)
    beta = rng.normal(0.0, 0.2, d).astype(np.float32)
    q = rng.integers(-127, 128, (2, 9, d)).astype(np.float32)
    q[0, 0] = 5.0  # zero variance
    q[0, 1] = np.where(np.arange(d) % 2, 32767.0, -32768.0)
    w = rng.normal(size=q.shape).astype(np.float32)

    def ours(v, g, b):
        o, so = int_layernorm(v, g, b, interp=SIM)
        return o * so

    def theirs(v, g, b):
        o, so = jax_int_layernorm(v, g, b, interp=JSIM)
        return o * so

    args = (_t(q, True), _t(gamma, True), _t(beta, True))
    _eq(ours(*args), theirs(*map(jnp.asarray, (q, gamma, beta))))
    gq, gg, gb = _grads(ours, args, w)
    jq, jgg, jb = _jax_grads(theirs, (q, gamma, beta), w)
    _close(gq, jq, atol=1e-6)
    _close(gg, jgg, atol=1e-6)
    assert not gb.any() and not np.asarray(jb).any()


@pytest.mark.parametrize("identity", [False, True], ids=["plain", "residual"])
@pytest.mark.parametrize("bits", [8, 16])
def test_sim_requantize_matches_jax(bits, identity):
    """The gradient reaches q, the residual and the (per-channel) input
    scale; the output scale is detached."""
    rng = np.random.default_rng(bits + 10 * identity)
    q = rng.integers(-2**20, 2**20, (6, 48)).astype(np.float32)
    idq = rng.integers(-2**15, 2**15, (6, 48)).astype(np.float32)
    s_in = rng.uniform(1e-6, 3e-6, 48).astype(np.float32)
    s_id, s_out = np.float32(3e-4), np.float32(0.4 if bits == 8 else 2e-3)
    w = rng.normal(size=q.shape).astype(np.float32)
    kw = {}

    def ours(v, si, iq):
        extra = {"identity_q": iq, "identity_scale": _t(s_id)} if identity else {}
        return requantize(v, si, _t(s_out), bits, interp=SIM, **extra)

    def theirs(v, si, iq):
        extra = {"identity_q": iq, "identity_scale": jnp.float32(s_id)} if identity else {}
        return jax_requantize(v, si, jnp.float32(s_out), bits, interp=JSIM, **extra, **kw)

    args = (_t(q, True), _t(s_in, True), _t(idq, True))
    _eq(ours(*args), theirs(*map(jnp.asarray, (q, s_in, idq))))
    for g, jg in zip(_grads(ours, args, w), _jax_grads(theirs, (q, s_in, idq), w)):
        _close(g, jg)


@pytest.mark.parametrize("bits", [8, 16])
def test_symmetric_scale_matches_jax(bits):
    """Several ranges, the eps clamp (a zero range) and |min| > max."""
    for mn, mx in ((-0.7, 0.6), (-3.1, 12.5), (0.0, 0.0), (-1e-9, 1e-9), (-2.0**-130, 0.0), (5.0, 7.0)):
        got = symmetric_scale(_t(np.float32(mn)), _t(np.float32(mx)), bits)
        _eq(got, jax_symmetric_scale(jnp.float32(mn), jnp.float32(mx), bits))


@pytest.mark.parametrize("shape", [(2, 5, 32, 96), (1, 3, 12, 7)], ids=["aligned", "ragged"])
def test_exact_int8_dots_match_jax(shape):
    """True int8 products (the ragged widths go through int8_matmul's
    padding) with the bias in int32; float32 gradients."""
    B, M, K, N = shape
    rng = np.random.default_rng(K)
    x = rng.integers(-128, 128, (B, M, K)).astype(np.float32)
    wq = rng.integers(-128, 128, (K, N)).astype(np.float32)
    b = rng.integers(-2**30, 2**30, N).astype(np.float32)
    g = rng.normal(size=(B, M, N)).astype(np.float32)
    args = (_t(x, True), _t(wq, True), _t(b, True))
    _eq(exact_int8_dot_bias(*args), jax_exact_int8_dot_bias(*map(jnp.asarray, (x, wq, b))))
    _eq(exact_int8_dot(*args[:2]), jax_exact_int8_dot(*map(jnp.asarray, (x, wq))))
    for ours, jg in zip(_grads(exact_int8_dot_bias, args, g), _jax_grads(jax_exact_int8_dot_bias, (x, wq, b), g)):
        _close(ours, jg, rtol=1e-6, atol=1e-6 * float(np.abs(jg).max()))
    np.testing.assert_array_equal(
        int8_matmul(_t(x[0]).to(torch.int8), _t(wq).to(torch.int8)).numpy(),
        x[0].astype(np.int64) @ wq.astype(np.int64))


@pytest.mark.parametrize("a_bits", [8, 16])
def test_exact_int_matmuls_match_jax(a_bits):
    """Attention's q·kᵀ (8×8) and probabilities·v (16×8, JAX's base-256
    split), exact, with float32 gradients."""
    rng = np.random.default_rng(a_bits)
    hi = 2 ** (a_bits - 1)
    a = rng.integers(-hi if a_bits == 8 else 0, hi, (2, 3, 17, 17)).astype(np.float32)
    b = rng.integers(-128, 128, (2, 3, 17, 8)).astype(np.float32)
    w = rng.normal(size=(2, 3, 17, 8)).astype(np.float32)
    ours, theirs = exact_int_matmul, (jax_mm_8x8 if a_bits == 8 else jax_mm_16x8)
    args = (_t(a, True), _t(b, True))
    _eq(ours(*args), theirs(jnp.asarray(a), jnp.asarray(b)))
    for g, jg in zip(_grads(ours, args, w), _jax_grads(theirs, (a, b), w)):
        _close(g, jg, rtol=1e-6, atol=1e-6 * float(np.abs(jg).max()))


def test_quant_matmul_takes_at_most_16x8_bits():
    """The ViT's products are 8 × 8 and 16 × 8 bits; a wider operand
    raises rather than taking an inexact float32 product."""
    a = QTensor(torch.ones(2, 4, 4), torch.tensor(0.5), 16)
    b = QTensor(torch.ones(2, 4, 3), torch.tensor(0.25), 8)
    out = quant_matmul(a, b)
    assert out.bits == 32 and float(out.scale) == 0.125 and torch.equal(out.q, torch.full((2, 4, 3), 4.0))
    with pytest.raises(ValueError, match="16 x 8"):
        quant_matmul(a.replace(bits=32), b)
    with pytest.raises(ValueError, match="16 x 8"):
        quant_matmul(a, b.replace(bits=16))
