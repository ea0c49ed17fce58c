"""Port ``core.dyadic`` and the engine's ``strict_dyadic`` ≡ JAX, bit for bit.

Tolerance 0 throughout. ``dyadic_decompose`` / ``dyadic_mul_exact`` /
``dyadic_requant`` are held to ``ivit_tpu.core.dyadic`` and to the
exact-int64 C++ oracle of ``ivit_tpu.native`` (the one
``tests/test_native_oracle.py`` uses) on seeded int32 z with the edges
±(2^31−1), −2^31, ±1, 0 and ties, at ratios from 2^−30 to 2^4. The
strict engine is held to ``ivit_tpu.deploy.build_vit_infer(use_pallas=
False, strict_dyadic=True)`` on JAX-frozen tiny artifacts.

At z = −2^31 the oracle computes ``-z`` in int32, which overflows
(undefined behaviour in C++; here it comes out as −2^31 and the result
takes the wrong sign). JAX's limb form takes the magnitude 2^31, and the
port follows JAX there: that z is held to JAX only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ivit_tpu.core import dyadic as jax_dyadic
from ivit_tpu.deploy import build_vit_infer as jax_build_vit_infer
from ivit_tpu.deploy import freeze_vit
from ivit_tpu.models import VisionTransformer
from ivit_tpu.native import dyadic_decompose_oracle, dyadic_mul_oracle, oracle_available
from ivit_tpu_torch.core.dyadic import Dyadic, dyadic_decompose, dyadic_mul_exact, dyadic_requant, requant_f32
from ivit_tpu_torch.deploy.engine import build_vit_infer
from ivit_tpu_torch.ops import INT8, requant

I32_MIN, I32_MAX = -(2**31), 2**31 - 1
# 2^-30 to 2^4: powers of two (every odd z is a tie at 2^-1 .. 2^-30) and
# ratios with a full mantissa
RATIOS = (2.0**-30, 2.0**-21, 7.3e-5, 2.0**-7, 0.0031, 0.37, 0.5, 1.0, 1.5, 7.9, 2.0**4)


def _z(ratio):
    """Seeded int32 z over the whole range, the edges first, then values
    whose product lands on an exact tie (z·m ≡ 2^(e−1) mod 2^e)."""
    rng = np.random.default_rng(int(ratio * 2**30) % 2**32)
    z = rng.integers(I32_MIN, I32_MAX, 2048, dtype=np.int64, endpoint=True)
    z[:9] = [I32_MAX, -I32_MAX, I32_MIN, 1, -1, 0, 3, -3, 2**30]
    m, e = (int(v[0]) for v in jax_dyadic.dyadic_decompose(jnp.float32([ratio])))
    # k·m ≡ 2^(e−1) (mod 2^e) with m = odd·2^t: k ≡ 2^(e−1−t)·odd⁻¹ (mod 2^(e−t))
    t = (m & -m).bit_length() - 1
    period = 2 ** (e - t)
    first = (2 ** (e - 1 - t) * pow(m >> t, -1, period)) % period if e - 1 >= t else 2**31
    if first < 2**31:  # ties, both signs
        ties = first + period * rng.integers(0, (2**31 - 1 - first) // period + 1, 64)
        z[9:73] = ties * np.where(np.arange(64) % 2 == 0, 1, -1)
    return z.astype(np.int32), m, e, first < 2**31


@pytest.mark.parametrize("ratio", RATIOS)
def test_decompose_matches_jax_and_oracle(ratio):
    r = np.float32([ratio, ratio * 1.25, ratio * 0.7])
    m, e = dyadic_decompose(torch.from_numpy(r))
    m_j, e_j = jax_dyadic.dyadic_decompose(jnp.asarray(r))
    np.testing.assert_array_equal(m.numpy(), np.asarray(m_j))
    np.testing.assert_array_equal(e.numpy(), np.asarray(e_j))
    if oracle_available():
        m_o, e_o = dyadic_decompose_oracle(r)
        np.testing.assert_array_equal(m.numpy(), m_o)
        np.testing.assert_array_equal(e.numpy(), e_o)
    assert m.dtype == torch.int32 and e.dtype == torch.int32


@pytest.mark.parametrize("ratio", RATIOS)
def test_mul_exact_matches_jax(ratio):
    z, m, e, _ = _z(ratio)
    ours = dyadic_mul_exact(torch.from_numpy(z), torch.full(z.shape, m, dtype=torch.int32),
                            torch.full(z.shape, e, dtype=torch.int32))
    theirs = jax_dyadic.dyadic_mul_exact(jnp.asarray(z), jnp.full(z.shape, m, jnp.int32), jnp.full(z.shape, e, jnp.int32))
    assert ours.dtype == torch.int32
    np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))


@pytest.mark.skipif(not oracle_available(), reason="no C++ toolchain")
@pytest.mark.parametrize("ratio", RATIOS)
def test_mul_exact_matches_oracle(ratio):
    z, m, e, has_ties = _z(ratio)
    if has_ties:  # the 64 built ties are exact ties
        assert all(abs(int(k)) * m % 2**e == 2 ** (e - 1) for k in z[9:73])
    z = z[z != I32_MIN]  # the oracle's -z overflows there (module docstring)
    ours = dyadic_mul_exact(torch.from_numpy(z), torch.tensor(m, dtype=torch.int32), torch.tensor(e, dtype=torch.int32))
    np.testing.assert_array_equal(ours.numpy(), dyadic_mul_oracle(z, m, e))


def test_ties_fall_in_int32_at_most_ratios():
    """Exact ties exist among int32 z at every non-integral ratio here
    but the two smallest full-mantissa ones (their period 2^(e−t)
    passes 2^31)."""
    with_ties = [r for r in RATIOS if _z(r)[3]]
    assert set(RATIOS) - set(with_ties) == {7.3e-5, 0.0031, 1.0, 2.0**4}


def test_mul_exact_rounds_ties_away_from_zero():
    m, e = dyadic_decompose(torch.tensor([0.5]))
    z = torch.tensor([1, -1, 3, -3, 5, -5], dtype=torch.int32)
    assert dyadic_mul_exact(z, m, e).tolist() == [1, -1, 2, -2, 3, -3]


def test_mul_exact_at_int32_min_follows_jax():
    """z = −2^31: magnitude 2^31 as in JAX's uint32 limbs, and a result
    past int32 wraps as JAX's does."""
    z = np.array([I32_MIN, I32_MIN], np.int32)
    for ratio in (0.37, 1.0, 1.5, 7.9):
        (m,), (e,) = dyadic_decompose_oracle(np.float32([ratio]))
        ours = dyadic_mul_exact(torch.from_numpy(z), torch.tensor(int(m), dtype=torch.int32),
                                torch.tensor(int(e), dtype=torch.int32))
        theirs = jax_dyadic.dyadic_mul_exact(jnp.asarray(z), jnp.full(2, m, jnp.int32), jnp.full(2, e, jnp.int32))
        np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))


def test_dyadic_requant_per_channel_matches_jax():
    rng = np.random.default_rng(5)
    z = rng.integers(-(2**24), 2**24, (64, 48)).astype(np.int32)
    r = (rng.uniform(0.5, 2.0, 48) * 2.0 ** rng.integers(-20, 2, 48)).astype(np.float32)
    ours = dyadic_requant(torch.from_numpy(z), torch.from_numpy(r))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(jax_dyadic.dyadic_requant(jnp.asarray(z), jnp.asarray(r))))
    # a Dyadic pair gives the same integers as the ratio it came from
    np.testing.assert_array_equal(dyadic_requant(torch.from_numpy(z), dyadic_decompose(torch.from_numpy(r))).numpy(),
                                  ours.numpy())


def test_requant_f32_matches_jax():
    rng = np.random.default_rng(6)
    z = rng.integers(-(2**26), 2**26, 4096).astype(np.int32)
    r = np.float32(0.0123)
    ours = requant_f32(torch.from_numpy(z), torch.tensor(r))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(jax_dyadic.requant_f32(jnp.asarray(z), jnp.asarray(r))))


def test_ops_requant_takes_a_dyadic_ratio():
    """``ops.requant`` with a ``Dyadic`` ratio is the clipped dyadic
    requant, as float32 (the JAX engine's ``_requant_strict``)."""
    rng = np.random.default_rng(7)
    acc = torch.from_numpy(rng.integers(-(2**20), 2**20, (32, 16)).astype(np.int32))
    ratio = torch.from_numpy(rng.uniform(1e-5, 3e-4, 16).astype(np.float32))
    pair = dyadic_decompose(ratio)
    assert isinstance(pair, Dyadic)
    out = requant(acc, pair, *INT8)
    assert out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), torch.clamp(dyadic_requant(acc, ratio), *INT8).numpy())


TINY = dict(img_size=16, patch_size=8, embed_dim=128, depth=2, num_heads=4)
# (softmax_bits, gelu_stable): the shipped sm8 + stable GELU and the
# reference-spec sm16 + row-max GELU
STRICT_CONFIGS = {"sm8_stable": (8, True), "sm16_rowmax": (16, False)}


@pytest.fixture(scope="module", params=sorted(STRICT_CONFIGS))
def frozen(request):
    bits, stable = STRICT_CONFIGS[request.param]
    model = VisionTransformer(**TINY, softmax_bits=bits, gelu_stable=stable)
    images = np.random.default_rng(0).standard_normal((4, 16, 16, 3)).astype(np.float32)
    variables = jax.jit(lambda rng, x: model.init(rng, x, train=True))(jax.random.PRNGKey(1), jnp.asarray(images))
    return freeze_vit(model, jax.tree.map(np.asarray, variables))


def test_strict_engine_matches_jax_strict_engine(frozen):
    images = np.random.default_rng(42).standard_normal((3, 16, 16, 3)).astype(np.float32)
    ours = build_vit_infer(frozen, "cpu", kernels=(), strict_dyadic=True)(torch.from_numpy(images)).numpy()
    theirs = jax.jit(jax_build_vit_infer(frozen, use_pallas=False, strict_dyadic=True))(jnp.asarray(images))
    np.testing.assert_array_equal(ours, np.asarray(theirs))
    assert np.all(np.isfinite(ours))


def test_strict_engine_with_kernels_raises(frozen):
    with pytest.raises(ValueError, match="strict_dyadic"):
        build_vit_infer(frozen, "cpu", strict_dyadic=True)  # the default kernels
    with pytest.raises(ValueError, match="strict_dyadic"):
        build_vit_infer(frozen, "cpu", kernels=("layernorm",), strict_dyadic=True)
