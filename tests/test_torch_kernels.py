"""Port kernels' plain versions ≡ the JAX Pallas kernels (interpret mode)
and the JAX XLA composition, bit for bit (tolerance 0), on the CPU; the
wrappers' input checks; the nvcc build lines.

The Pallas GELU kernels (K4, K5) form ``s_in·1.702`` and the softmax
kernels (K2, K6) ``−1/scale`` in float64 at trace time, the XLA ops and
the port in float32; every scale used here is float32-valued and one at
which the floors of the two quotients agree (``_same_x0`` asserts it).

The CUDA kernels themselves run only on a GPU: their tests are in
``tests/test_torch_cuda.py``, which imports no JAX.
"""

import ctypes
import functools
import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ivit_tpu.kernels import fused_layernorm_requant as jax_fused_layernorm_requant
from ivit_tpu.kernels import fused_requant_shiftgelu as jax_fused_requant_shiftgelu
from ivit_tpu.kernels import fused_requant_shiftmax as jax_fused_requant_shiftmax
from ivit_tpu.kernels import _shiftmax_common as jax_k0
from ivit_tpu.kernels.attention_fused import fused_int8_attention as jax_fused_int8_attention
from ivit_tpu.kernels.attention_fused_v2 import fused_int8_attention_v2 as jax_fused_int8_attention_v2
from ivit_tpu.kernels.linear_gelu_fused import fused_linear_shiftgelu as jax_fused_linear_shiftgelu
from ivit_tpu.ops import DEPLOY
from ivit_tpu.ops import shiftgelu as jax_shiftgelu
from ivit_tpu.ops import shiftmax as jax_shiftmax
from ivit_tpu_torch.deploy.engine import build_vit_infer
from ivit_tpu_torch.deploy.synthetic import synthetic_vit_artifact
from ivit_tpu_torch.kernels.attention_fused import attention_probabilities
from ivit_tpu_torch.kernels.attention_fused_v2 import scale_gate
from ivit_tpu_torch.kernels import (
    _build,
    _gelu_common,
    _shiftmax_common as k0,
    fused_int8_attention,
    fused_int8_attention_reference,
    fused_int8_attention_v2,
    fused_int8_attention_v2_reference,
    fused_layernorm_requant,
    fused_layernorm_requant_reference,
    fused_linear_shiftgelu,
    fused_linear_shiftgelu_reference,
    fused_requant_shiftgelu,
    fused_requant_shiftgelu_reference,
    fused_requant_shiftmax,
    fused_requant_shiftmax_reference,
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


@pytest.mark.parametrize("C", [128, 1024, 384, 1536], ids=["merged_stats", "split_stats", "deit_s", "swin_t_stage_4"])
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


def _gate_edge_scale(N=197):
    """The smallest float32 scale that passes K2's gate at N tokens."""
    s = np.float32(1.0 / (2.0**31 / (N * 2.0**15)))
    while not scale_gate(N, float(s)):
        s = np.nextafter(s, np.float32(np.inf))
    assert not scale_gate(N, float(np.nextafter(s, np.float32(0))))
    return float(s)


# power-of-two 1/scale (p = 2, 4, 8, 64), the test scale, DeiT-like ones,
# and the edge of K2's gate at DeiT-S's 197 tokens
TABLE_SCALES = (0.5, 0.25, 0.125, 1.0 / 64, 0.07, 0.021, 0.0031, _gate_edge_scale())


@pytest.mark.parametrize("scale", TABLE_SCALES)
def test_shift_exp_table_matches_jax(scale):
    """K1 and K2's per-launch table: entry i is the shift-exp at z = −i,
    for every row-max-subtracted int8 score, clip on (K1) and off (K2)."""
    z = -np.arange(256, dtype=np.float32)
    for clip in (True, False):
        table = k0.shift_exp_table(scale, 15, clip).numpy()
        je = jax_k0.shift_exp_rows(jnp.asarray(z), jnp.float32(scale), 15.0, jnp.ones(256, bool), clip_e=clip)
        np.testing.assert_array_equal(table, np.asarray(je))
        np.testing.assert_array_equal(table, k0.shift_exp_rows(_t(z), _t(np.float32(scale)), 15, _t(np.ones(256, bool)), clip).numpy())
    # the largest entry is z = 0's, p·2^15 (at most 2^31 under the clip)
    p = -math.floor(-1.0 / float(np.float32(scale)))
    assert float(table.max()) == float(table[0]) == p * 2.0**15


@functools.cache
def _route_b_scales() -> tuple:
    """The Shiftmax input scale of each block of the synthetic DeiT-S
    artifact at 16-bit probabilities, as route B hands it to K6."""
    art = synthetic_vit_artifact("deit_small", seed=0, softmax_bits=16, gelu_stable=False)
    return tuple(b["attn"]["scale"] for b in build_vit_infer(art, "cpu", kernels=()).tensors["blocks"])


@pytest.mark.parametrize("block", range(12))
def test_shift_exp_table_matches_jax_at_route_b_scales(block):
    """K6's per-launch table (K1's, clip on) at route B's scale of each
    DeiT-S block: entry i is JAX's shift-exp at z = −i."""
    scale = _route_b_scales()[block]
    assert np.float32(scale) == scale
    z = -np.arange(256, dtype=np.float32)
    je = jax_k0.shift_exp_rows(jnp.asarray(z), jnp.float32(scale), 15.0, jnp.ones(256, bool), clip_e=True)
    np.testing.assert_array_equal(k0.shift_exp_table(scale, 15, True).numpy(), np.asarray(je))


@pytest.mark.parametrize("out_bits", [8, 16])
def test_attention_one_token_rows_match_xla(out_bits):
    """N = 1 with a power-of-two 1/scale: each row's one probability is
    2^(out_bits−1) = 128 or 32768, one past what a signed 8- or 16-bit
    value holds. The port's K1 and K2 plain versions (and so their CUDA
    kernels, which take the @V operand as unsigned bytes) equal the JAX
    engine's XLA composition there. The JAX Pallas K1 does not at 16 bits:
    its split ``hi.astype(jnp.int8)``
    (``ivit_tpu/kernels/attention_fused.py:52``) saturates hi = 128 to
    127, and on these inputs it returns 88 and −89 where the spec gives
    89 and −90 (a JAX-side deviation, left as it is)."""
    G, N, hd = 4, 1, 8
    rng = np.random.default_rng(out_bits)
    q, k, v = (rng.integers(-128, 128, (G, N, hd)).astype(np.int8) for _ in range(3))
    v[0] = 127
    v[1] = -128
    r1, scale = float(np.float32(1e-3)), 0.125
    r_out = float(np.float32((1.0 / 2 ** (out_bits - 1)) * 0.7))
    probs = attention_probabilities(_t(q), _t(k), r1, scale, out_bits)
    assert (probs == 2.0 ** (out_bits - 1)).all()
    xla = _jax_attention_xla(q, k, v, r1, scale, r_out, out_bits)
    ours = fused_int8_attention_reference(_t(q), _t(k), _t(v), r1, scale, r_out, out_bits).numpy()
    np.testing.assert_array_equal(ours, xla)
    ours2 = fused_int8_attention_v2_reference(_t(q), _t(k), _t(v), r1, scale, r_out, N, out_bits).numpy()
    np.testing.assert_array_equal(ours2, xla)
    assert (xla[0] == 89).all() and (xla[1] == -90).all()


def test_cuda_sources_and_build_line():
    for f in _build.SOURCES + _build.HEADERS:
        assert os.path.isfile(os.path.join(_build.CSRC, f)), f
    assert set(_build.SOURCES) == {
        "attention_fused.cu", "attention_fused_v2.cu", "attention_long.cu", "intnorm_fused.cu",
        "linear_gelu_fused.cu", "shiftgelu_fused.cu", "shiftmax_fused.cu", "stable_gelu_fused.cu",
        "window_attention_fused.cu",
    }
    for source in _build.SOURCES:
        cmd = " ".join(_build.nvcc_command(source, "/tmp/x.so", nvcc="nvcc"))
        assert cmd == (
            "nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false "
            f"-shared -Xcompiler -fPIC -o /tmp/x.so {os.path.join(_build.CSRC, source)}"
        )
        assert _build.lib_path(source).startswith(_build.BUILD_DIR)
    # every pointer argument is a c_void_p (a c_int would cut it to 32 bits)
    for entry_points in _build._ENTRY_POINTS.values():
        for name, argtypes in entry_points.items():
            assert argtypes[-1] is ctypes.c_void_p, name  # the stream
            # a kernel's inputs and output; K4's table filler has one tensor
            assert argtypes.count(ctypes.c_void_p) >= (2 if name == "ivit_gelu_table" else 3), name
    # K5 reads its chain from the GELU table: x, r1, table, out, M, C, stream;
    # K3 picks its row-group width and load width itself
    P, I = ctypes.c_void_p, ctypes.c_int
    assert _build._ENTRY_POINTS["shiftgelu_fused.cu"]["ivit_fused_requant_shiftgelu"] == (P, P, P, P, I, I, P)
    assert _build._ENTRY_POINTS["intnorm_fused.cu"]["ivit_fused_layernorm_requant"] == (P, P, P, P, I, I, P)
    # the build directory is ignored by git
    gitignore = open(os.path.join(os.path.dirname(_build.CSRC), "..", ".gitignore")).read()
    assert "build/" in gitignore.split()


def test_magic_number_steps_have_one_definition():
    """The exact int <-> float32 steps (kMagic, int_to_float,
    requant_bits, floor_bits) and the one-wave grid of the grid-stride kernels are
    defined once, in the header every kernel includes."""
    shared = "shiftmax_common.cuh"
    for f in _build.SOURCES + _build.HEADERS:
        text = open(os.path.join(_build.CSRC, f)).read()
        for definition in ("float kMagic =", "int kMagicBits =", "float int_to_float(", "int requant_bits(",
                           "int floor_bits(", "cudaOccupancyMaxActiveBlocksPerMultiprocessor("):
            assert text.count(definition) == (f == shared), (f, definition)


# ---- K5 / K4: the row-max ShiftGELU chain (n = 23) ----------------------


def _same_x0(scale_f32, factor=1.0):
    """The Pallas kernels' float64 x0 equals the float32 one at this scale."""
    s64 = float(scale_f32) * factor
    s32 = np.float32(scale_f32) * np.float32(factor)
    assert math.floor(-1.0 / s64) == math.floor(float(np.float32(-1.0) / s32))


def _gelu_rows(M, C, seed):
    """int32 fc1 accumulators (M, C) and per-channel ratios: spread rows, an
    all-negative row, and rows pinned at the int8 clip edges."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-(2**20), 2**20, (M, C)).astype(np.int32)
    r1 = (rng.uniform(0.5, 2.0, (C,)) * 1e-4).astype(np.float32)
    x[0] = -np.abs(x[0]) - 1  # all negative: e_max saturates
    x[1, ::2], x[1, 1::2] = 2**30, -(2**30)  # +127 / −128
    x[2] = -(2**30)  # all −128
    return x, r1


S_IN, R2 = float(np.float32(0.031)), float(np.float32(0.7))


def _jax_gelu_xla(q, s_in, r2):
    g, _ = jax_shiftgelu(jnp.asarray(q), jnp.float32(s_in), out_bits=8, interp=DEPLOY)
    return np.clip(np.round(np.asarray(g) * np.float32(r2)), -128, 127).astype(np.int8)


@pytest.mark.parametrize("s_in", [0.0021, 0.031, 0.4, 1.9])
def test_gelu_twin_matches_jax_ops(s_in):
    s_in = float(np.float32(s_in))
    rng = np.random.default_rng(7)
    q = rng.integers(-128, 128, (6, 96)).astype(np.float32)
    q[0] = -np.abs(q[0]) - 1
    q[1] = -128.0
    q[2] = 127.0
    ours = _gelu_common.shiftgelu_rowmax_requant(_t(q), s_in, R2).numpy()
    np.testing.assert_array_equal(ours, _jax_gelu_xla(q, s_in, R2))


def test_shiftgelu_reference_matches_jax_kernel():
    M, C = 48, 256
    x, r1 = _gelu_rows(M, C, 2)
    _same_x0(S_IN, 1.702)
    ours = fused_requant_shiftgelu_reference(_t(x), _t(r1), S_IN, R2).numpy()
    theirs = jax_fused_requant_shiftgelu(jnp.asarray(x), jnp.asarray(r1), S_IN, R2, out_bits=8, interpret=True)
    np.testing.assert_array_equal(ours, np.asarray(theirs))
    q = np.clip(np.round(x.astype(np.float32) * r1), -128, 127)
    np.testing.assert_array_equal(ours, _jax_gelu_xla(q, S_IN, R2))
    assert len(np.unique(ours)) > 20 and (ours[0] <= 0).all()
    np.testing.assert_array_equal(fused_requant_shiftgelu(_t(x), _t(r1), S_IN, R2).numpy(), ours)


def test_linear_gelu_reference_matches_jax_kernel():
    M, K, C = 64, 48, 128  # the size of tests/test_kernels.py's K4 test
    rng = np.random.default_rng(0)
    x = rng.integers(-128, 128, (M, K)).astype(np.int8)
    w = rng.integers(-128, 128, (K, C)).astype(np.int8)
    b = rng.integers(-(2**15), 2**15, (C,)).astype(np.int32)
    r1 = (rng.uniform(0.5, 2.0, (C,)) * 1e-4).astype(np.float32)
    x[0] = 0  # all-zero row: acc = b
    x[1], w[:, :64] = 127, 127  # clips at the int8 edge
    s_in, r2 = float(np.float32(0.031)), float(np.float32(0.52))
    _same_x0(s_in, 1.702)
    w_k = _t(np.ascontiguousarray(w.T)).T  # (K, C), K-contiguous
    ours = fused_linear_shiftgelu_reference(_t(x), w_k, _t(b), _t(r1), s_in, r2).numpy()
    theirs = jax_fused_linear_shiftgelu(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), jnp.asarray(r1),
        s_in=s_in, r2=r2, out_bits=8, interpret=True,
    )
    np.testing.assert_array_equal(ours, np.asarray(theirs))
    assert len(np.unique(ours)) > 20
    np.testing.assert_array_equal(fused_linear_shiftgelu(_t(x), w_k, _t(b), _t(r1), s_in, r2).numpy(), ours)


# GELU input scales from small to large against output ratios, float32
GELU_TABLE_SCALES = [(0.0021, 0.7), (0.031, 0.7), (0.031, 0.052), (0.4, 1.3), (1.9, 0.011)]


@pytest.mark.parametrize("s_in,r2", GELU_TABLE_SCALES)
def test_gelu_table_matches_chain(s_in, r2):
    """K4's table holds the row-max chain's output of every (q, max q)
    with q ≤ max, the 128 all-negative rows (e_max saturates) among them,
    equal to the twin's chain on whole rows and to the JAX op; the
    entries past the max, which no row reads, are 0."""
    s_in, r2 = float(np.float32(s_in)), float(np.float32(r2))
    table = _gelu_common.gelu_table(s_in, r2).numpy()
    byte = np.arange(256)
    row_max = np.where(byte < 128, byte, byte - 256)
    # row i holds every q <= int8(i) once, then repeats it: its max is int8(i)
    q = np.minimum(np.arange(-128, 128)[None, :], row_max[:, None]).astype(np.float32)
    chain = _gelu_common.shiftgelu_rowmax_requant(_t(q), s_in, r2).numpy()
    np.testing.assert_array_equal(table[byte[:, None], q.astype(np.int64) & 0xFF], chain)
    np.testing.assert_array_equal(chain, _jax_gelu_xla(q, s_in, r2))
    value = np.where(byte < 128, byte, byte - 256)
    assert (table[value[None, :] > row_max[:, None]] == 0).all()
    assert len(np.unique(chain)) > 20


def test_linear_gelu_through_the_table_matches_reference():
    """K4's arithmetic: the requantized product's row max, then one table
    lookup an element, equals the plain version; on spread rows, an
    all-negative row and rows tied at their max."""
    M, K, C = 64, 48, 128
    rng = np.random.default_rng(3)
    x = rng.integers(-128, 128, (M, K)).astype(np.int8)
    w = rng.integers(-128, 128, (K, C)).astype(np.int8)
    b = rng.integers(-(2**15), -(2**14), (C,)).astype(np.int32)
    r1 = (rng.uniform(0.5, 2.0, (C,)) * 4e-4).astype(np.float32)
    x[0] = 0  # acc = b < 0: every q of the row is negative
    x[1], w[:, :16] = 127, 127  # 16 columns clip at +127: ties at the max
    s_in, r2 = float(np.float32(0.031)), float(np.float32(0.52))
    w_k = _t(np.ascontiguousarray(w.T)).T
    ref = fused_linear_shiftgelu_reference(_t(x), w_k, _t(b), _t(r1), s_in, r2)
    acc = _t(x).long() @ _t(w).long() + _t(b).long()
    q = torch.clamp(torch.round(acc.to(torch.float32) * _t(r1)), -128, 127)
    row_max = torch.amax(q, dim=-1, keepdim=True)
    table = _gelu_common.gelu_table(s_in, r2)
    looked = table[row_max.long() & 0xFF, q.long() & 0xFF]
    torch.testing.assert_close(looked, ref, rtol=0, atol=0)
    assert (q[0] < 0).all() and int((q[1] == row_max[1]).sum()) > 1
    assert ref.unique().numel() > 20


@pytest.mark.parametrize("shape", [(48, 256), (25, 1536), (33, 256), (5, 100)])
def test_shiftgelu_through_the_table_matches_reference(shape):
    """K5's arithmetic: requant, the row max, then one table lookup an
    element, equals the plain version, the JAX XLA ops and (C a multiple
    of 128) the Pallas K5 in interpret mode; on spread rows, an
    all-negative row, rows at the int8 clip edges and a row tied at its
    max of +127."""
    M, C = shape
    x, r1 = _gelu_rows(M, C, seed=C)
    x[0] -= 2**15  # every q of row 0 below zero: e_max saturates
    x[3, ::5] = 2**30  # every fifth channel clips at +127: ties at the max
    _same_x0(S_IN, 1.702)
    ref = fused_requant_shiftgelu_reference(_t(x), _t(r1), S_IN, R2)
    q = torch.clamp(torch.round(_t(x).to(torch.float32) * _t(r1)), -128, 127)
    row_max = torch.amax(q, dim=-1, keepdim=True)
    table = _gelu_common.gelu_table(S_IN, R2)
    looked = table[row_max.long() & 0xFF, q.long() & 0xFF]
    torch.testing.assert_close(looked, ref, rtol=0, atol=0)
    np.testing.assert_array_equal(ref.numpy(), _jax_gelu_xla(q.numpy(), S_IN, R2))
    if C % 128 == 0:
        theirs = jax_fused_requant_shiftgelu(jnp.asarray(x), jnp.asarray(r1), S_IN, R2, out_bits=8, interpret=True)
        np.testing.assert_array_equal(ref.numpy(), np.asarray(theirs))
    assert (q[0] < 0).all() and int((q[3] == 127).sum()) > 1 and (ref[0] <= 0).all()


@pytest.mark.parametrize("case", ["int8_input", "odd_width", "r1_shape", "r1_dtype", "r1_device", "non_contiguous"])
def test_shiftgelu_wrapper_rejects(case):
    x, r1 = torch.zeros((4, 16), dtype=torch.int32), torch.ones(16)
    if case == "int8_input":
        x = x.to(torch.int8)
    elif case == "odd_width":
        x, r1 = torch.zeros((4, 18), dtype=torch.int32), torch.ones(18)
    elif case == "r1_shape":
        r1 = torch.ones(15)
    elif case == "r1_dtype":
        r1 = r1.double()
    elif case == "r1_device":
        r1 = r1.to("meta")
    elif case == "non_contiguous":
        x = torch.zeros((16, 4), dtype=torch.int32).T
    with pytest.raises(ValueError):
        fused_requant_shiftgelu(x, r1, S_IN, R2)


@pytest.mark.parametrize("case", ["row_major_w", "k_mismatch", "k_not_multiple_of_4", "b_dtype", "r1_shape", "too_wide"])
def test_linear_gelu_wrapper_rejects(case):
    M, K, C = 4, 32, 16
    x = torch.zeros((M, K), dtype=torch.int8)
    w = torch.zeros((C, K), dtype=torch.int8).T
    b, r1 = torch.zeros(C, dtype=torch.int32), torch.ones(C)
    if case == "row_major_w":
        w = torch.zeros((K, C), dtype=torch.int8)
    elif case == "k_mismatch":
        w = torch.zeros((C, K + 4), dtype=torch.int8).T
    elif case == "k_not_multiple_of_4":
        x, w = torch.zeros((M, 30), dtype=torch.int8), torch.zeros((C, 30), dtype=torch.int8).T
    elif case == "b_dtype":
        b = b.to(torch.int64)
    elif case == "r1_shape":
        r1 = torch.ones(C + 1)
    elif case == "too_wide":
        w, b, r1 = torch.zeros((8192, K), dtype=torch.int8).T, torch.zeros(8192, dtype=torch.int32), torch.ones(8192)
    with pytest.raises(ValueError):
        fused_linear_shiftgelu(x, w, b, r1, S_IN, R2)


# ---- K6: requant → masked Shiftmax → (hi, lo) ---------------------------


def _decode(hi, lo):
    return 256 * np.asarray(hi, np.int32) + np.asarray(lo, np.int32) + 128


@pytest.mark.parametrize(
    "N,n_valid,out_bits,scale",
    [
        pytest.param(197, 197, 16, 0.021, id="197-197-16"),
        pytest.param(40, 33, 16, 0.021, id="40-33-16"),
        pytest.param(40, 40, 8, 0.021, id="40-40-8"),
        # one-token rows at a power-of-two 1/scale: sm = 2^15, hi saturates
        pytest.param(1, 1, 16, 0.125, id="1-1-16-pow2"),
        pytest.param(256, 1, 16, 0.125, id="256-1-16-pow2"),
        pytest.param(256, 256, 16, 0.021, id="256-256-16"),
    ],
)
def test_shiftmax_reference_matches_jax_kernel(N, n_valid, out_bits, scale):
    M, Npad = 24, 256
    rng = np.random.default_rng(N + n_valid)
    x = rng.integers(-(2**20), 2**20, (M, N)).astype(np.int32)
    x[0] = 0  # a uniform row
    x[1, :n_valid] = -(2**20)  # every valid score at −128
    x[2, 0] = 2**30  # one-hot
    r1, scale = float(np.float32(3.1e-5)), float(np.float32(scale))
    _same_x0(scale)
    hi, lo = fused_requant_shiftmax_reference(_t(x), r1, scale, n_valid, out_bits)
    jhi, jlo = jax_fused_requant_shiftmax(
        jnp.asarray(np.pad(x, ((0, 0), (0, Npad - N)))), r1, scale,
        n_valid=n_valid, out_bits=out_bits, interpret=True,
    )
    sm, jsm = _decode(hi.numpy(), lo.numpy()), _decode(jhi, jlo)
    np.testing.assert_array_equal(sm, jsm[:, :N])
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi)[:, :N])
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo)[:, :N])
    # masked and pad columns decode to exactly 0; the probabilities spread,
    # or a one-token row's 2^15 saturates hi to 127 (decoding to 2^15 − 256)
    assert (sm[:, n_valid:] == 0).all() and (jsm[:, N:] == 0).all()
    if n_valid == 1:
        assert (hi.numpy()[:, 0] == 127).all() and (lo.numpy()[:, 0] == -128).all()
    else:
        assert len(np.unique(sm)) > (5 if out_bits == 8 else 20)
    got = fused_requant_shiftmax(_t(x), r1, scale, n_valid, out_bits)
    np.testing.assert_array_equal(got[0].numpy(), hi.numpy())
    np.testing.assert_array_equal(got[1].numpy(), lo.numpy())


@pytest.mark.parametrize("case", ["int8_input", "three_dims", "n_above_256", "n_valid_0", "n_valid_above_n", "out_bits_12"])
def test_shiftmax_wrapper_rejects(case):
    x, n_valid, bits = torch.zeros((4, 16), dtype=torch.int32), 16, 16
    if case == "int8_input":
        x = x.to(torch.int8)
    elif case == "three_dims":
        x = x.reshape(2, 2, 16)
    elif case == "n_above_256":
        x, n_valid = torch.zeros((2, 257), dtype=torch.int32), 257
    elif case == "n_valid_0":
        n_valid = 0
    elif case == "n_valid_above_n":
        n_valid = 17
    elif case == "out_bits_12":
        bits = 12
    with pytest.raises(ValueError):
        fused_requant_shiftmax(x, 1e-4, 0.05, n_valid, out_bits=bits)


# ---- K2: fused attention, v2 value semantics ----------------------------


@pytest.mark.parametrize("out_bits", [8, 16])
def test_attention_v2_reference_matches_jax_kernel(out_bits):
    B, H, N, hd, Mpad, Npad = 2, 3, 17, 8, 32, 128
    q, k, v = _attention_inputs(B * H, N, hd, 10 + out_bits)
    r1, scale, r_out = _ratios(hd, out_bits)
    _same_x0(scale)
    ours = fused_int8_attention_v2_reference(_t(q), _t(k), _t(v), r1, scale, r_out, N, out_bits).numpy()

    def heads(a):
        return a.reshape(B, H, N, hd)

    qp = np.pad(heads(q), ((0, 0), (0, 0), (0, Mpad - N), (0, 0)))
    kp = np.pad(heads(k).transpose(0, 1, 3, 2), ((0, 0), (0, 0), (0, 0), (0, Npad - N)))
    vp = np.pad(heads(v), ((0, 0), (0, 0), (0, Npad - N), (0, 0)))
    theirs = jax_fused_int8_attention_v2(
        jnp.asarray(qp), jnp.asarray(kp), jnp.asarray(vp), r1=r1, scale=scale, r_out=r_out,
        n_valid=N, out_bits=out_bits, interpret=True,
    )
    np.testing.assert_array_equal(ours, np.asarray(theirs)[:, :, :N].reshape(B * H, N, hd))
    # under the gate v2's shortcuts are exact: K1's integers
    k1 = fused_int8_attention_reference(_t(q), _t(k), _t(v), r1, scale, r_out, out_bits).numpy()
    np.testing.assert_array_equal(ours, k1)
    assert len(np.unique(ours)) > 20
    got = fused_int8_attention_v2(_t(q), _t(k), _t(v), r1, scale, r_out, N, out_bits)
    np.testing.assert_array_equal(got.numpy(), ours)


def test_attention_v2_gate_raises():
    N, hd, scale = 17, 8, 1e-4  # N * ceil(1/scale) * 2^15 = 5.6e9 > 2^31
    q, k, v = _attention_inputs(2, N, hd, 3)
    with pytest.raises(ValueError, match="gate"):
        fused_int8_attention_v2(_t(q), _t(k), _t(v), 1e-3, scale, 1e-2, N, 16)
    # the JAX kernel refuses the same scale
    z = jnp.zeros((1, 1, 32, hd), jnp.int8)
    with pytest.raises(AssertionError):
        jax_fused_int8_attention_v2(
            z, jnp.zeros((1, 1, hd, 128), jnp.int8), jnp.zeros((1, 1, 128, hd), jnp.int8),
            r1=1e-3, scale=scale, r_out=1e-2, n_valid=N, out_bits=16, interpret=True,
        )


@pytest.mark.parametrize("case", ["int16_dtype", "shape_mismatch", "n_valid_short", "out_bits_12", "non_contiguous"])
def test_attention_v2_wrapper_rejects(case):
    q = torch.zeros((2, 17, 8), dtype=torch.int8)
    k, v, n_valid, bits = q.clone(), q.clone(), 17, 16
    if case == "int16_dtype":
        q = q.to(torch.int16)
    elif case == "shape_mismatch":
        k = torch.zeros((2, 16, 8), dtype=torch.int8)
    elif case == "n_valid_short":
        n_valid = 16
    elif case == "out_bits_12":
        bits = 12
    elif case == "non_contiguous":
        v = torch.zeros((2, 8, 17), dtype=torch.int8).transpose(1, 2)
    with pytest.raises(ValueError):
        fused_int8_attention_v2(q, k, v, 1e-3, 0.07, 1e-2, n_valid, out_bits=bits)
