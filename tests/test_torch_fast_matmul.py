"""``nn/quant.py``'s two additions against JAX's on the CPU: the
``--fast-matmul`` backward (``SIM_FAST_MATMUL``) and ``QuantConv2d``.

``--fast-matmul``: JAX's switch sets the exact dots' backward to
``Precision.DEFAULT``, which on the TPU rounds both operands to bf16 and
sums in float32, but which JAX on the CPU computes in full float32. So
the port is held to JAX's dot of operands cast explicitly to bf16 with
``preferred_element_type=float32``: both sum exact products (a bf16
product is exact in float32) in float32, in their own orders, so each
entry agrees within ``2·(K−1)·2^-24·Σ|aᵢ·bᵢ|`` (SUM_ORDER_ULPS). The
forward stays integer-exact: bit-equal with the switch on and off. In a
model the gradients move from the float32 ones by the bf16 rounding of
every backward GEMM: within FAST_GRAD_RTOL (2^-5, 16 units of bf16's
2^-9) of each leaf's largest entry; 0.0087 is the largest measured here
(DeiT-S at full width: 0.0079).

``QuantConv2d``: JAX convolves the integer values in float32 at
``HIGHEST``, exact while its sums stay below 2^24; the port's im2col
and int8 dot are exact at any size. The test's sums stay below 2^24
(|x| ≤ 127, |w| ≤ 127, at most 36 taps: 580,644), so the two agree with
tolerance 0; gradients within 1e-5 of each leaf's largest entry
(float32 sums in other orders); and the float oracle bound of
``tests/test_nn.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ivit_tpu.core.qtensor import QTensor as JaxQTensor
from ivit_tpu.nn.quant import QuantConv2d as JaxQuantConv2d
from ivit_tpu_torch.core.qtensor import QTensor
from ivit_tpu_torch.models import create_model
from ivit_tpu_torch.nn import QuantConv2d, exact_int8_dot_bias, exact_int_matmul, load_flax_variables, quant
from ivit_tpu_torch.train import soft_target_cross_entropy
from tests.torch_threads import one_torch_thread  # noqa: F401

SUM_ORDER_ULPS = 2  # in units of (K − 1)·2^-24·Σ|aᵢ·bᵢ| (module docstring)
FAST_GRAD_RTOL = 2.0**-5
GRAD_RTOL = 1e-5

bf16 = jnp.bfloat16


@pytest.fixture
def fast(monkeypatch):
    monkeypatch.setattr(quant, "SIM_FAST_MATMUL", True)


def _int8(rng, *shape):
    return rng.integers(-128, 128, shape).astype(np.float32)


def _jax_bf16_dot(a, b, contract):
    """JAX's dot of ``a`` and ``b`` rounded to bf16, summed in float32."""
    return np.asarray(jax.lax.dot_general(jnp.asarray(a, bf16), jnp.asarray(b, bf16), (contract, ((), ())),
                                          preferred_element_type=jnp.float32))


def _assert_within_sum_order(ours, theirs, a, b, contract):
    """|ours − theirs| ≤ SUM_ORDER_ULPS·(K−1)·2^-24·Σ|aᵢ·bᵢ|, entry by entry."""
    a16 = np.asarray(jnp.asarray(a, bf16).astype(jnp.float32), np.float64)
    b16 = np.asarray(jnp.asarray(b, bf16).astype(jnp.float32), np.float64)
    k = int(np.prod([a.shape[i] for i in contract[0]]))
    mags = np.asarray(jax.lax.dot_general(jnp.asarray(np.abs(a16)), jnp.asarray(np.abs(b16)), (contract, ((), ()))))
    bound = SUM_ORDER_ULPS * (k - 1) * 2.0**-24 * mags
    assert np.all(np.abs(ours.astype(np.float64) - theirs) <= bound)


def test_fast_backward_of_the_linear_dot_matches_jax_bf16(fast):
    rng = np.random.default_rng(0)
    x, w, b = _int8(rng, 2, 5, 48), _int8(rng, 48, 24), rng.integers(-1000, 1000, 24).astype(np.float32)
    g = rng.standard_normal((2, 5, 24)).astype(np.float32)
    xt, wt, bt = (torch.from_numpy(a).requires_grad_() for a in (x, w, b))
    y = exact_int8_dot_bias(xt, wt, bt)
    dx, dw, db = torch.autograd.grad(y, (xt, wt, bt), torch.from_numpy(g))
    _assert_within_sum_order(dx.numpy(), _jax_bf16_dot(g, w.T, ((2,), (0,))), g, w.T, ((2,), (0,)))
    _assert_within_sum_order(dw.numpy(), _jax_bf16_dot(x, g, ((0, 1), (0, 1))), x, g, ((0, 1), (0, 1)))
    with pytest.MonkeyPatch.context() as mp:  # the bias gradient is a sum, not a GEMM: unchanged
        mp.setattr(quant, "SIM_FAST_MATMUL", False)
        db_full = torch.autograd.grad(exact_int8_dot_bias(xt, wt, bt), bt, torch.from_numpy(g))[0]
    assert torch.equal(db, db_full)


def test_fast_backward_of_the_batched_dot_matches_jax_bf16(fast):
    rng = np.random.default_rng(1)
    a = rng.integers(-2**15, 2**15, (2, 3, 7, 16)).astype(np.float32)  # 16 x 8 bits, as attn @ v
    b = _int8(rng, 2, 3, 16, 8)
    g = rng.standard_normal((2, 3, 7, 8)).astype(np.float32)
    at, bt = torch.from_numpy(a).requires_grad_(), torch.from_numpy(b).requires_grad_()
    da, db = torch.autograd.grad(exact_int_matmul(at, bt), (at, bt), torch.from_numpy(g))
    bT, aT = np.swapaxes(b, -1, -2), np.swapaxes(a, -1, -2)
    jda = np.asarray(jnp.matmul(jnp.asarray(g, bf16), jnp.asarray(bT, bf16), preferred_element_type=jnp.float32))
    jdb = np.asarray(jnp.matmul(jnp.asarray(aT, bf16), jnp.asarray(g, bf16), preferred_element_type=jnp.float32))
    for ours, theirs, lhs, rhs in ((da, jda, g, bT), (db, jdb, aT, g)):
        k = lhs.shape[-1]
        lhs16 = np.asarray(jnp.asarray(lhs, bf16).astype(jnp.float32), np.float64)
        rhs16 = np.asarray(jnp.asarray(rhs, bf16).astype(jnp.float32), np.float64)
        bound = SUM_ORDER_ULPS * (k - 1) * 2.0**-24 * (np.abs(lhs16) @ np.abs(rhs16))
        assert np.all(np.abs(ours.numpy().astype(np.float64) - theirs) <= bound)


def test_fast_matmul_leaves_the_forward_and_moves_the_backward():
    """A train-mode step of a tiny QAT ViT: the logits and loss bit-equal
    with the switch on and off (the forward is integer-exact either way),
    every gradient within FAST_GRAD_RTOL of its float32 value, and some
    gradient really changed."""
    cfg = dict(img_size=16, patch_size=8, num_classes=8, embed_dim=32, depth=2, num_heads=4)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((4, 16, 16, 3)).astype(np.float32))
    targets = torch.full((4, 8), 0.1 / 8)
    targets[torch.arange(4), torch.tensor([1, 5, 0, 7])] += 0.9
    runs = {}
    for on in (False, True):
        model = create_model("deit_tiny", "cpu", seed=0, **cfg)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(quant, "SIM_FAST_MATMUL", on)
            logits = model(x, train=True)
            loss = soft_target_cross_entropy(logits, targets)
            grads = torch.autograd.grad(loss, list(model.parameters()), materialize_grads=True)
        runs[on] = logits.detach(), loss.detach(), grads
    assert torch.equal(runs[True][0], runs[False][0]) and torch.equal(runs[True][1], runs[False][1])
    moved = False
    for fast_g, full_g in zip(runs[True][2], runs[False][2]):
        scale = float(full_g.abs().max())
        assert float((fast_g - full_g).abs().max()) <= FAST_GRAD_RTOL * scale
        moved |= not torch.equal(fast_g, full_g)
    assert moved
    assert quant.SIM_FAST_MATMUL is False


def _conv_pair(padding, strides, seed=0):
    jm = JaxQuantConv2d(features=6, kernel_size=(3, 3), strides=strides, padding=padding)
    rng = np.random.default_rng(seed)
    img = rng.integers(-127, 128, (2, 9, 9, 4)).astype(np.float32)
    jx = JaxQTensor(q=jnp.asarray(img), scale=jnp.float32(0.02), bits=8)
    variables = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(1), jx))
    variables["params"]["bias"] = rng.normal(0, 0.05, 6).astype(np.float32)  # a bias to quantize
    tm = load_flax_variables(QuantConv2d(4, 6, (3, 3), strides, padding), variables)
    return jm, variables, img, jx, tm


@pytest.mark.parametrize("padding,strides", [("VALID", (2, 2)), ("VALID", (1, 1)), ("SAME", (2, 2)), ("SAME", (1, 2))])
def test_quant_conv2d_matches_jax(padding, strides):
    jm, variables, img, jx, tm = _conv_pair(padding, strides)
    out = jm.apply(variables, jx)
    ours = tm(QTensor(torch.from_numpy(img), torch.tensor(0.02), 8))
    assert ours.shape == out.q.shape and ours.bits == 32
    np.testing.assert_array_equal(ours.q.detach().numpy(), np.asarray(out.q))
    np.testing.assert_array_equal(ours.scale.detach().numpy(), np.asarray(out.scale))

    def jax_loss(params, q):
        o = jm.apply({"params": params}, JaxQTensor(q=q, scale=jnp.float32(0.02), bits=8))
        return jnp.sum(o.dequantize() * jnp.arange(o.q.size, dtype=jnp.float32).reshape(o.q.shape) / o.q.size)

    jg, jgx = jax.grad(jax_loss, argnums=(0, 1))(variables["params"], jnp.asarray(img))
    xt = torch.from_numpy(img).requires_grad_()
    o = tm(QTensor(xt, torch.tensor(0.02), 8))
    loss = (o.dequantize() * torch.arange(o.q.numel(), dtype=torch.float32).reshape(o.q.shape) / o.q.numel()).sum()
    gk, gb, gx = torch.autograd.grad(loss, (tm.kernel, tm.bias, xt))
    for ours_g, theirs_g in ((gk, jg["kernel"]), (gb, jg["bias"]), (gx, jgx)):
        theirs_g = np.asarray(theirs_g)
        assert float(np.abs(ours_g.numpy() - theirs_g).max()) <= GRAD_RTOL * float(np.abs(theirs_g).max())


def test_quant_conv2d_vs_float_oracle():
    """``tests/test_nn.py``'s bound: the dequantized output within the
    int8 weight quantization error of the float convolution."""
    _, variables, img, _, tm = _conv_pair("VALID", (2, 2))
    with torch.no_grad():
        out = tm(QTensor(torch.from_numpy(img), torch.tensor(0.02), 8))
    assert out.shape == (2, 4, 4, 6) and out.scale.shape == (6,)
    kernel, bias = (torch.from_numpy(np.array(variables["params"][k])) for k in ("kernel", "bias"))
    x = torch.from_numpy(img) * 0.02
    oracle = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), kernel.permute(3, 2, 0, 1), stride=2)
    oracle = oracle.permute(0, 2, 3, 1) + bias
    err = (out.dequantize() - oracle).abs().max()
    bound = float(kernel.abs().max()) / 127 * float(x.abs().sum())
    assert float(err) <= bound + 1e-4
