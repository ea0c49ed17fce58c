"""Port kernels' plain versions ≡ the JAX Pallas kernels (interpret mode)
and the JAX XLA composition, bit for bit (tolerance 0), on the CPU; the
wrappers' input checks; the nvcc build line.

The CUDA kernels themselves run only on a GPU: their tests are in
``tests/test_torch_cuda.py``, which imports no JAX.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ivit_tpu.kernels import fused_layernorm_requant as jax_fused_layernorm_requant
from ivit_tpu.kernels import _shiftmax_common as jax_k0
from ivit_tpu.kernels.attention_fused import fused_int8_attention as jax_fused_int8_attention
from ivit_tpu.ops import DEPLOY
from ivit_tpu.ops import shiftmax as jax_shiftmax
from ivit_tpu_torch.kernels import (
    _build,
    _shiftmax_common as k0,
    fused_int8_attention,
    fused_int8_attention_reference,
    fused_layernorm_requant,
    fused_layernorm_requant_reference,
)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _attention_inputs(G, N, hd, seed):
    """int8 q, k, v with one query row of tied scores (q = 0) and one
    saturated row (q = 127 against large keys)."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.integers(-128, 128, (G, N, hd)).astype(np.int8) for _ in range(3))
    q[0, 0] = 0
    q[0, 1] = 127
    k[0, :, :] = np.where(np.arange(N)[:, None] % 2 == 0, 127, -128)
    return q, k, v


def _ratios(hd, out_bits):
    # random rows spread over about a third of the int8 range
    r1 = float(np.float32(127.0 / (3 * np.sqrt(hd) * 74.0**2)))
    scale = float(np.float32(0.07))
    r_out = float(np.float32((1.0 / 2 ** (out_bits - 1)) * 0.05 / 0.021))
    return r1, scale, r_out


def _jax_attention_xla(q, k, v, r1, scale, r_out, out_bits):
    """The JAX engine's XLA composition: int dot → requant → DEPLOY
    shiftmax → exact int @V → requant."""
    qi, ki, vi = (jnp.asarray(a, jnp.int32) for a in (q, k, v))
    attn = jnp.einsum("gnd,gmd->gnm", qi, ki).astype(jnp.float32)
    a8 = jnp.clip(jnp.round(attn * jnp.float32(r1)), -128, 127)
    sm, _ = jax_shiftmax(a8, jnp.float32(scale), out_bits=out_bits, interp=DEPLOY)
    ctx = jnp.einsum("gnm,gmd->gnd", sm.astype(jnp.int32), vi).astype(jnp.float32)
    return np.asarray(jnp.clip(jnp.round(ctx * jnp.float32(r_out)), -128, 127).astype(jnp.int8))


@pytest.mark.parametrize("out_bits", [8, 16])
def test_attention_reference_matches_jax_kernel_and_xla(out_bits):
    G, N, hd, Npad = 3, 17, 8, 128
    q, k, v = _attention_inputs(G, N, hd, out_bits)
    r1, scale, r_out = _ratios(hd, out_bits)
    ours = fused_int8_attention_reference(_t(q), _t(k), _t(v), r1, scale, r_out, out_bits).numpy()

    pad = ((0, 0), (0, Npad - N), (0, 0))
    jk = jax_fused_int8_attention(
        *(jnp.asarray(np.pad(a, pad)) for a in (q, k, v)),
        r1=r1, scale=scale, r_out=r_out, n_valid=N, out_bits=out_bits, interpret=True,
    )
    np.testing.assert_array_equal(ours, np.asarray(jk)[:, :N])
    np.testing.assert_array_equal(ours, _jax_attention_xla(q, k, v, r1, scale, r_out, out_bits))
    # not vacuous: the context spans many int8 values
    assert len(np.unique(ours)) > 20


def test_attention_wrapper_cpu_runs_reference():
    q, k, v = (_t(a) for a in _attention_inputs(2, 17, 8, 5))
    r1, scale, r_out = _ratios(8, 8)
    torch.testing.assert_close(
        fused_int8_attention(q, k, v, r1, scale, r_out),
        fused_int8_attention_reference(q, k, v, r1, scale, r_out),
        rtol=0, atol=0,
    )


@pytest.mark.parametrize(
    "case",
    ["int16_dtype", "two_dims", "shape_mismatch", "hd_not_multiple_of_4", "n_above_256", "out_bits_12", "non_contiguous"],
)
def test_attention_wrapper_rejects(case):
    q = torch.zeros((2, 17, 8), dtype=torch.int8)
    k, v, bits = q.clone(), q.clone(), 8
    if case == "int16_dtype":
        q = q.to(torch.int16)
    elif case == "two_dims":
        q, k, v = q[0], k[0], v[0]
    elif case == "shape_mismatch":
        k = torch.zeros((2, 16, 8), dtype=torch.int8)
    elif case == "hd_not_multiple_of_4":
        q, k, v = (torch.zeros((2, 17, 6), dtype=torch.int8) for _ in range(3))
    elif case == "n_above_256":
        q, k, v = (torch.zeros((1, 257, 8), dtype=torch.int8) for _ in range(3))
    elif case == "out_bits_12":
        bits = 12
    elif case == "non_contiguous":
        q = torch.zeros((2, 8, 17), dtype=torch.int8).transpose(1, 2)
    with pytest.raises(ValueError):
        fused_int8_attention(q, k, v, 1e-3, 0.07, 1e-2, out_bits=bits)


@pytest.mark.parametrize("C", [128, 1024], ids=["merged_stats", "split_stats"])
def test_layernorm_reference_matches_jax_kernel(C):
    rng = np.random.default_rng(C)
    x = rng.integers(-(2**15), 2**15, (9, C)).astype(np.int16)
    x[0] = 3  # zero variance
    x[1, ::2], x[1, 1::2] = 32767, -32768
    x[2] = rng.integers(-60, 60, C)
    bias = np.floor(rng.standard_normal(C) * 2**24).astype(np.float32)
    ratio = (rng.uniform(0.5, 2.0, C) * np.sqrt(C) * 2.0**-25).astype(np.float32)
    ours = fused_layernorm_requant_reference(_t(x), _t(bias), _t(ratio)).numpy()
    theirs = jax_fused_layernorm_requant(
        jnp.asarray(x, jnp.float32), jnp.asarray(bias), jnp.asarray(ratio), interpret=True
    )
    np.testing.assert_array_equal(ours, np.asarray(theirs))
    assert len(np.unique(ours)) > 20
    np.testing.assert_array_equal(fused_layernorm_requant(_t(x), _t(bias), _t(ratio)).numpy(), ours)


@pytest.mark.parametrize("case", ["float32_input", "three_dims", "bias_shape", "ratio_dtype", "non_contiguous"])
def test_layernorm_wrapper_rejects(case):
    x = torch.zeros((4, 16), dtype=torch.int16)
    bias, ratio = torch.zeros(16), torch.ones(16)
    if case == "float32_input":
        x = x.float()
    elif case == "three_dims":
        x = x.reshape(2, 2, 16)
    elif case == "bias_shape":
        bias = torch.zeros(15)
    elif case == "ratio_dtype":
        ratio = ratio.double()
    elif case == "non_contiguous":
        x = torch.zeros((16, 4), dtype=torch.int16).T
    with pytest.raises(ValueError):
        fused_layernorm_requant(x, bias, ratio)


@pytest.mark.parametrize("out_bits", [8, 16])
def test_k0_twin_matches_jax(out_bits):
    rng = np.random.default_rng(out_bits)
    z = -rng.integers(0, 256, (4, 64)).astype(np.float32)
    z[:, 0] = 0.0
    valid = np.arange(64) < 50
    for s in (0.5, 0.07, 0.006):
        e = k0.shift_exp_rows(_t(z), _t(np.float32(s)), 15, _t(valid))
        je = jax_k0.shift_exp_rows(jnp.asarray(z), jnp.float32(s), 15.0, jnp.asarray(valid))
        np.testing.assert_array_equal(e.numpy(), np.asarray(je))
        esum = torch.clamp(k0.exact_rowsum_2limb(e), 1.0, 2.0**31 - 1)
        jsum = jnp.clip(jax_k0.exact_rowsum_2limb(je), 1.0, 2.0**31 - 1)
        np.testing.assert_array_equal(esum.numpy(), np.asarray(jsum))
        np.testing.assert_array_equal(
            k0.norm_factor(esum, out_bits).numpy(), np.asarray(jax_k0.norm_factor(jsum, out_bits))
        )


def test_cuda_sources_and_build_line():
    for f in _build.SOURCES + _build.HEADERS:
        assert os.path.isfile(os.path.join(_build.CSRC, f)), f
    cmd = " ".join(_build.nvcc_command("/tmp/x.so", nvcc="nvcc"))
    assert cmd.startswith(
        "nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false "
        "-shared -Xcompiler -fPIC -o /tmp/x.so "
    )
    assert "--use_fast_math" not in cmd
    assert cmd.endswith("csrc/attention_fused.cu " + os.path.join(_build.CSRC, "intnorm_fused.cu"))
    # the build directory is ignored by git
    gitignore = open(os.path.join(os.path.dirname(_build.CSRC), "..", ".gitignore")).read()
    assert "build/" in gitignore.split()
