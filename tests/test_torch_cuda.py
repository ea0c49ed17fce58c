"""The port's proof on the card, with ``tests/test_torch_cuda_ranks.py``:
each CUDA kernel bit-equal (tolerance 0) to its plain torch version, at
edge inputs and on the published paths' own inputs; every path at its
published width and depth, eager and as a CUDA graph, bit-equal to
``kernels=()`` and to the CPU; the serving and training entry points,
pretrained import and exported engines on the card. Times are the
benchmark's (``benchmark/``), not these tests'.

Every test here needs a CUDA device and skips without one (the kernels
have no CPU mode). The file imports no JAX, so it runs on a machine
without it; from the repository root:

    python -m pytest tests/test_torch_cuda.py tests/test_torch_cuda_ranks.py -m cuda -q --noconftest -p no:cacheprovider

(``--noconftest``: ``tests/conftest.py`` imports JAX.) The full-width
engine and graph tests run before the QAT tests, so these run after a
process's heaviest capture churn.
"""

import ast
import contextlib
import copy
import gc
import importlib.util
import json
import math
import os
import pickle
import re
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

from ivit_tpu_torch.core.qtensor import QTensor
from ivit_tpu_torch.deploy.convert import freeze_vit
from ivit_tpu_torch.deploy.engine import build_vit_infer
from ivit_tpu_torch.deploy.export import export_engine, load_engine
from ivit_tpu_torch.deploy.graphs import capture_infer
from ivit_tpu_torch.deploy.swin_engine import build_swin_infer
from ivit_tpu_torch.deploy.swin_synthetic import synthetic_swin_artifact
from ivit_tpu_torch.deploy.synthetic import synthetic_vit_artifact
from ivit_tpu_torch.kernels import (
    WRAPPERS,
    fused_int8_attention,
    fused_int8_attention_long,
    fused_int8_attention_long_reference,
    fused_int8_attention_reference,
    fused_int8_attention_v2,
    fused_int8_attention_v2_reference,
    fused_int8_window_attention,
    fused_int8_window_attention_reference,
    fused_layernorm_requant,
    fused_layernorm_requant_reference,
    fused_linear_shiftgelu,
    fused_linear_shiftgelu_reference,
    fused_requant_shiftgelu,
    fused_requant_shiftgelu_reference,
    fused_requant_shiftmax,
    fused_requant_shiftmax_reference,
    fused_requant_stable_gelu,
    fused_requant_stable_gelu_reference,
    stable_gelu_table,
)
from ivit_tpu_torch.kernels._gelu_common import gelu_table, gelu_table_on
from ivit_tpu_torch.kernels.attention_fused import attention_probabilities
from ivit_tpu_torch.models import create_model
from ivit_tpu_torch.models.swin import sw_attn_mask
from ivit_tpu_torch.train import AdamW, create_train_state, make_train_step, soft_target_cross_entropy
from ivit_tpu_torch.utils import spans
from torch_parallel_worker import count_launches, swin_kernel_errors, vit_kernel_errors
from torch_reference_state import augreg_npz, vit_state

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _attention_case(G, N, hd, out_bits, seed, scale=0.07):
    """int8 q, k, v with a row of tied scores and (N > 1) a saturated row,
    and ratios that spread the other rows over about a third of int8."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.integers(-128, 128, (G, N, hd)).astype(np.int8) for _ in range(3))
    q[0, 0] = 0
    if N > 1:
        q[0, 1] = 127
    k[0] = np.where(np.arange(N)[:, None] % 2 == 0, 127, -128)
    r1 = float(np.float32(127.0 / (3 * np.sqrt(hd) * 74.0**2)))
    r_out = float(np.float32((1.0 / 2 ** (out_bits - 1)) * 0.05 / 0.021))
    return [torch.from_numpy(a) for a in (q, k, v)], (r1, float(np.float32(scale)), r_out)


# the DeiT-S shape, N = 256 at hd = 128, a small ragged one, and every
# N in ATTENTION_N against every hd in ATTENTION_HD: one key, one and two
# short of and past the 32-key chunks of the MMA kernel, Swin's 49, and
# hd from the smallest to the largest the kernels take
ATTENTION_N = (1, 2, 31, 32, 33, 49, 255)
ATTENTION_HD = (4, 32, 256)
ATTENTION_SHAPES = [(6, 197, 64), (3, 256, 128), (5, 17, 8)] + [(3, n, hd) for n in ATTENTION_N for hd in ATTENTION_HD]


def _attention_ids(shape):
    return "x".join(map(str, shape))


@pytest.mark.parametrize("out_bits", [8, 16])
@pytest.mark.parametrize("shape", ATTENTION_SHAPES, ids=_attention_ids)
def test_attention_kernel_matches_reference(dev, shape, out_bits):
    qkv, ratios = _attention_case(*shape, out_bits, seed=out_bits)
    out = _launched_once(fused_int8_attention, *(a.to(dev) for a in qkv), *ratios, out_bits)
    ref = fused_int8_attention_reference(*qkv, *ratios, out_bits)
    torch.testing.assert_close(out.cpu(), ref, rtol=0, atol=0)


@pytest.mark.parametrize("shape", [(197, 384), (33, 100), (40, 1024), (3136, 96), (784, 192), (49, 1536)])
def test_layernorm_kernel_matches_reference(dev, shape):
    rng = np.random.default_rng(shape[1])
    x = rng.integers(-(2**15), 2**15, shape).astype(np.int16)
    x[0] = 3  # zero variance
    bias = np.floor(rng.standard_normal(shape[1]) * 2**24).astype(np.float32)
    ratio = (rng.uniform(0.5, 2.0, shape[1]) * np.sqrt(shape[1]) * 2.0**-25).astype(np.float32)
    args = [torch.from_numpy(a) for a in (x, bias, ratio)]
    out = _launched_once(fused_layernorm_requant, *(a.to(dev) for a in args))
    torch.testing.assert_close(out.cpu(), fused_layernorm_requant_reference(*args), rtol=0, atol=0)


def _layernorm_edges(M, C, seed):
    """int16 rows with the edges of the statistics (zero variance at 3
    and at -32768, alternating 32767 and -32768, values in +-60), spread
    rows elsewhere, an integer beta and ratios that spread the output
    over int8."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-(2**15), 2**15, (M, C)).astype(np.int16)
    x[0] = 3
    x[1] = -(2**15)
    x[2, ::2], x[2, 1::2] = 32767, -32768
    x[3] = rng.integers(-60, 61, C)
    bias = np.floor(rng.standard_normal(C) * 2**24).astype(np.float32)
    ratio = (rng.uniform(0.5, 2.0, C) * np.sqrt(C) * 2.0**-25).astype(np.float32)
    return [torch.from_numpy(a) for a in (x, bias, ratio)]


def _layernorm_on_card(dev, x, bias, ratio):
    """K3 on the card beside its plain version on the card, one launch."""
    args = [a.to(dev) for a in (x, bias, ratio)]
    out = _launched_once(fused_layernorm_requant, *args)
    return out, fused_layernorm_requant_reference(*args)


# every width the paths run (Swin-T's four stages and merges, DeiT-S), at
# a row count past one resident wave of blocks and not a multiple of the
# rows of a block, and at the width's batch-128 row count on its path, on
# edge rows, with 16-byte loads and, from a base 2 bytes past a 16-byte
# boundary, with the scalar instantiation (an eighth of the rows, plus 3)
LAYERNORM_BATCH_128_ROWS = {96: 401408, 192: 100352, 384: 25216, 768: 25088, 1536: 6272}


@pytest.mark.parametrize("rows", ["wave", "batch128"])
@pytest.mark.parametrize("aligned", [True, False], ids=["vec", "unaligned"])
@pytest.mark.parametrize("C", [96, 192, 384, 768, 1536])
def test_layernorm_kernel_at_path_widths(dev, C, aligned, rows):
    if rows == "wave":
        M = 100003 if aligned else 20011
    else:
        M = LAYERNORM_BATCH_128_ROWS[C] if aligned else LAYERNORM_BATCH_128_ROWS[C] // 8 + 3
    x, bias, ratio = _layernorm_edges(M, C, seed=C)
    if not aligned:
        buf = torch.empty(x.numel() + 1, dtype=torch.int16, device=dev)
        buf[1:] = x.reshape(-1).to(dev)
        x = buf[1:].view(x.shape)
        assert x.data_ptr() % 16 == 2
    out, ref = _layernorm_on_card(dev, x, bias, ratio)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    assert ref.unique().numel() > 20


# the first and last width of every row group the kernel picks: with
# 16-byte loads (3 chunks of 8 channels a lane: groups of 1-32 lanes end at
# 24, 48, 96, 192, 384 and 768 channels) and with scalar loads (8
# channels a lane: 8, 16, 32, 64, 128 and 256)
@pytest.mark.parametrize("C", [8, 9, 16, 17, 24, 32, 33, 48, 56, 64, 65, 96, 104, 128, 129, 192, 200, 256, 257,
                               384, 392, 768, 776])
def test_layernorm_kernel_at_row_group_edges(dev, C):
    x, bias, ratio = _layernorm_edges(4099, C, seed=C)
    out, _ = _layernorm_on_card(dev, x, bias, ratio)
    torch.testing.assert_close(out.cpu(), fused_layernorm_requant_reference(x, bias, ratio), rtol=0, atol=0)


# ragged widths (scalar loads), the last merged-statistics width and the
# first split one, and the widest row the kernel takes
@pytest.mark.parametrize("shape", [(1003, 100), (1003, 33), (517, 1000), (517, 1001), (67, 8192)])
def test_layernorm_kernel_at_ragged_and_split_widths(dev, shape):
    x, bias, ratio = _layernorm_edges(*shape, seed=shape[1])
    out, _ = _layernorm_on_card(dev, x, bias, ratio)
    torch.testing.assert_close(out.cpu(), fused_layernorm_requant_reference(x, bias, ratio), rtol=0, atol=0)


@pytest.mark.parametrize("out_bits", [8, 16])
@pytest.mark.parametrize("shape", ATTENTION_SHAPES, ids=_attention_ids)
def test_attention_v2_kernel_matches_reference(dev, shape, out_bits):
    qkv, ratios = _attention_case(*shape, out_bits, seed=10 + out_bits)
    N = shape[1]
    out = _launched_once(fused_int8_attention_v2, *(a.to(dev) for a in qkv), *ratios, N, out_bits)
    ref = fused_int8_attention_v2_reference(*qkv, *ratios, N, out_bits)
    torch.testing.assert_close(out.cpu(), ref, rtol=0, atol=0)
    # under K2's gate: K1's integers
    torch.testing.assert_close(ref, fused_int8_attention_reference(*qkv, *ratios, out_bits), rtol=0, atol=0)


# (G, N, hd): four cells at 1, 17 and 197 tokens; five cells at every N
# in (1, 17, 32, 33, 197, 256) against every hd in (8, 32, 64, 128); the
# DeiT-S main path's cell counts at batch 128 and 1 (768 and 6), at 197
# tokens and at one
ATTENTION_EDGE_SHAPES = ([(4, n, 64) for n in (1, 17, 197)]
                         + [(5, n, hd) for n in (1, 17, 32, 33, 197, 256) for hd in (8, 32, 64, 128)]
                         + [(g, n, 64) for g in (768, 6) for n in (197, 1)])


@pytest.mark.parametrize("out_bits", [8, 16])
@pytest.mark.parametrize("scale", [0.125, 0.07], ids=["pow2", "spread"])
@pytest.mark.parametrize("shape", ATTENTION_EDGE_SHAPES, ids=_attention_ids)
def test_attention_kernels_at_edges(dev, shape, scale, out_bits):
    """A power-of-two 1/scale (one-token rows reach probability
    2^(out_bits-1): 128, 32768) and a spread one, rows of equal scores,
    and rows clipped at -128 and +127 against V = -128 (the largest
    |context|)."""
    G, N, hd = shape
    qkv, (r1, scale, r_out) = _attention_case(G, N, hd, out_bits, seed=N, scale=scale)
    q, k, v = qkv
    q[1], k[1] = 0, 5  # all scores 0: every column ties
    q[2], k[2], v[2] = 127, -128, -128  # every score clips at -128
    q[3], k[3], v[3] = 127, 127, -128  # every score clips at +127
    probs = attention_probabilities(q, k, r1, scale, out_bits)
    if N == 1 and scale == 0.125:
        assert float(probs.max()) == 2.0 ** (out_bits - 1)
    for fn, ref, extra in (
        (fused_int8_attention, fused_int8_attention_reference, ()),
        (fused_int8_attention_v2, fused_int8_attention_v2_reference, (N,)),
    ):
        args = (r1, scale, r_out, *extra, out_bits)
        out = fn(*(a.to(dev) for a in qkv), *args)
        torch.testing.assert_close(out.cpu(), ref(*qkv, *args), rtol=0, atol=0)


def _gelu_case(M, C, seed):
    """int32 accumulators with an all-negative row and rows at the int8 clip
    edges, and per-channel ratios that spread the rest over int8."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-(2**20), 2**20, (M, C)).astype(np.int32)
    r1 = (rng.uniform(0.5, 2.0, (C,)) * 1e-4).astype(np.float32)
    x[0] = -np.abs(x[0]) - 1
    if M > 2:
        x[1, ::2], x[1, 1::2] = 2**30, -(2**30)
        x[2] = -(2**30)
    return torch.from_numpy(x), torch.from_numpy(r1)


GELU_SCALES = (float(np.float32(0.031)), float(np.float32(0.7)))


@pytest.mark.parametrize("shape", [(197, 1536), (33, 256), (5, 100)])
def test_shiftgelu_kernel_matches_reference(dev, shape):
    x, r1 = _gelu_case(*shape, seed=shape[1])
    out = _launched_once(fused_requant_shiftgelu, x.to(dev), r1.to(dev), *GELU_SCALES)
    ref = fused_requant_shiftgelu_reference(x, r1, *GELU_SCALES)
    torch.testing.assert_close(out.cpu(), ref, rtol=0, atol=0)


# the route-B shape at batch 128, small rows and a ragged width, and
# widths past the 1,536 channels a lane keeps in registers
@pytest.mark.parametrize("shape", [(25216, 1536), (33, 256), (5, 100), (37, 1540), (100, 2048)])
def test_shiftgelu_kernel_on_edge_rows(dev, shape):
    """K5 on the edge rows: all negative (e_max saturates), +127 / -128
    alternating, all -128, and tied at a max of +127 (every fifth
    channel clips), on the card against its plain version there."""
    x, r1 = _gelu_case(*shape, seed=shape[0])
    x[0] -= 2**15  # every q of row 0 below zero: e_max saturates
    if shape[0] > 3:
        x[3, ::5] = 2**30
    args = (x.to(dev), r1.to(dev), *GELU_SCALES)
    out = _launched_once(fused_requant_shiftgelu, *args)
    ref = fused_requant_shiftgelu_reference(*args)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    assert (ref[0] <= 0).all() and ref.unique().numel() > 20


@pytest.mark.parametrize("shape", [(197, 384, 1536), (64, 48, 128), (45, 100, 200)])
def test_linear_gelu_kernel_matches_reference(dev, shape):
    M, K, C = shape
    rng = np.random.default_rng(M)
    x = torch.from_numpy(rng.integers(-128, 128, (M, K)).astype(np.int8))
    w_t = torch.from_numpy(rng.integers(-128, 128, (C, K)).astype(np.int8))
    b = torch.from_numpy(rng.integers(-(2**15), 2**15, (C,)).astype(np.int32))
    # ratios that spread x@w (std ~ 74^2 * sqrt(K)) over about a third of int8
    r1 = torch.from_numpy((rng.uniform(0.5, 2.0, (C,)) * 40.0 / (74.0**2 * np.sqrt(K))).astype(np.float32))
    x[0] = 0
    args = (b, r1, *GELU_SCALES)
    out = _launched_once(fused_linear_shiftgelu, x.to(dev), w_t.to(dev).T, *(a.to(dev) for a in args[:2]), *GELU_SCALES)
    ref = fused_linear_shiftgelu_reference(x, w_t.T, *args)
    torch.testing.assert_close(out.cpu(), ref, rtol=0, atol=0)
    assert ref.unique().numel() > 20


def _linear_gelu_case(M, K, C, seed):
    """int8 x and w, int32 b and ratios that spread x@w over a third of
    int8; row 0 is all negative (x = 0 against a bias below zero: e_max
    saturates) and row 1 ties at its max (x = 127 against 16 columns of
    127, which clip)."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-128, 128, (M, K)).astype(np.int8)
    w_t = rng.integers(-128, 128, (C, K)).astype(np.int8)
    b = rng.integers(-(2**15), -(2**14), (C,)).astype(np.int32)
    r1 = (rng.uniform(0.5, 2.0, (C,)) * 40.0 / (74.0**2 * np.sqrt(K))).astype(np.float32)
    x[0] = 0
    x[1], w_t[:16] = 127, 127
    return [torch.from_numpy(a) for a in (x, w_t, b, r1)]


# DeiT-S fc1 at batch 128 and 1, and an M and a C that are not multiples
# of the 64-row blocks and 256-column chunks, with K not a multiple of the
# 64-byte weight stages
@pytest.mark.parametrize("shape", [(25216, 384, 1536), (197, 384, 1536), (25211, 384, 1496), (1000, 96, 200)])
def test_linear_gelu_kernel_at_path_and_ragged_shapes(dev, shape):
    x, w_t, b, r1 = _linear_gelu_case(*shape, seed=shape[0])
    out = _launched_once(fused_linear_shiftgelu, x.to(dev), w_t.to(dev).T, b.to(dev), r1.to(dev), *GELU_SCALES)
    ref = fused_linear_shiftgelu_reference(x.to(dev), w_t.to(dev).T, b.to(dev), r1.to(dev), *GELU_SCALES)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    assert (ref[0] <= 0).all() and ref.unique().numel() > 20


@pytest.mark.parametrize("s_in,r2", [(0.0021, 0.7), (0.031, 0.7), (0.4, 1.3), (1.9, 0.011)])
def test_gelu_table_on_card_matches_twin(dev, s_in, r2):
    s_in, r2 = float(np.float32(s_in)), float(np.float32(r2))
    torch.testing.assert_close(gelu_table_on(dev, s_in, r2).cpu(), gelu_table(s_in, r2), rtol=0, atol=0)


def _stable_gelu_case(M, C, seed):
    """K9's inputs: int32 accumulators, a bias and per-channel ratios; most
    q spread over int8, every seventh channel above 2^24 in |x + b| (odd:
    the float32 conversion rounds) at a ratio that keeps it in range,
    row 1 clipping at +127 and row 2 at -128, channel 3's bias add
    wrapping; and the table of a DeiT-like block."""
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
        x[:, 3] = np.abs(x[:, 3]) + 1
    # a DeiT-like output ratio s_in / 2^7 / s_out: outputs spread over int8
    table = stable_gelu_table(torch.tensor(np.float32(0.031)), torch.tensor(np.float32(0.008)))
    return [torch.from_numpy(a) for a in (x, b, r1)] + [table]


# DeiT-S fc1 at batch 128 and 1, ragged Ms, widths that are not
# multiples of 128 words, a C that is not a multiple of 4 (one channel a
# thread), and the per-rank width at TP = 2
K9_SHAPES = [(25216, 1536), (197, 1536), (25211, 1536), (1003, 1536), (37, 1540), (5, 99), (25216, 768)]


@pytest.mark.parametrize("shape", K9_SHAPES)
def test_stable_gelu_kernel_matches_reference(dev, shape):
    x, b, r1, table = _stable_gelu_case(*shape, seed=shape[0] + shape[1])
    args = [a.to(dev) for a in (x, b, r1, table)]
    out = _launched_once(fused_requant_stable_gelu, *args)
    torch.testing.assert_close(out.cpu(), fused_requant_stable_gelu_reference(x, b, r1, table), rtol=0, atol=0)
    assert out.unique().numel() > (50 if shape[0] > 100 else 20)


@pytest.mark.parametrize("shape", [(1000, 1536)] + K9_SHAPES[:3] + K9_SHAPES[4:6])
def test_stable_gelu_kernel_off_16_byte_boundaries(dev, shape):
    """x, b and r1 whose bases lie 4 bytes past a 16-byte boundary take
    the one-channel path; the result is the same."""
    x, b, r1, table = _stable_gelu_case(*shape, seed=3)

    def offset(t):
        out = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)[1:].view(t.shape)
        return out.copy_(t)

    xd, bd, rd = offset(x), offset(b), offset(r1)
    assert xd.data_ptr() % 16 and bd.data_ptr() % 16 and rd.data_ptr() % 16
    out = fused_requant_stable_gelu(xd, bd, rd, table.to(dev))
    torch.testing.assert_close(out.cpu(), fused_requant_stable_gelu_reference(x, b, r1, table), rtol=0, atol=0)


@pytest.mark.parametrize("s,r", [(1e-4, 0.02), (0.0021, 0.9), (0.031, 0.7), (0.4, 1.3), (1.9, 0.05), (40.0, 0.011)])
def test_stable_gelu_table_on_card_matches_cpu(dev, s, r):
    scale, ratio = torch.tensor(np.float32(s)), torch.tensor(np.float32(r))
    torch.testing.assert_close(stable_gelu_table(scale.to(dev), ratio.to(dev)).cpu(), stable_gelu_table(scale, ratio),
                               rtol=0, atol=0)


# (M, N, n_valid): route B's batch-1 shape, and M of 7 and 1182 (neither a
# multiple of the kernel's 16-row tile) at every N in (1, 5, 197, 256)
# with n_valid at N, at about half of it and at 1
SHIFTMAX_SHAPES = [(64, 256, 200)] + sorted({(m, n, v) for m in (7, 1182) for n in (1, 5, 197, 256)
                                             for v in (n, (n + 1) // 2, 1)})


@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "offset"])
@pytest.mark.parametrize("out_bits", [8, 16])
@pytest.mark.parametrize("scale", [0.021, 0.125], ids=["spread", "pow2"])
@pytest.mark.parametrize("shape", SHIFTMAX_SHAPES)
def test_shiftmax_kernel_matches_reference(dev, shape, scale, out_bits, offset):
    """Rows: uniform, one-hot at 2^30, every valid score at −128, spread
    elsewhere; at a power-of-two 1/scale a one-token row's sm is 2^15 and
    hi saturates to 127. ``offset`` starts x 4 bytes past a 16-byte
    boundary (the kernel's 4-byte copies)."""
    M, N, n_valid = shape
    rng = np.random.default_rng(N)
    x = rng.integers(-(2**20), 2**20, (M, N)).astype(np.int32)
    x[0] = 0
    x[1, 0] = 2**30
    x[2] = -(2**30)
    x = torch.from_numpy(x)
    buf = torch.empty(M * N + offset, dtype=torch.int32, device=dev)
    buf[offset:] = x.reshape(-1).to(dev)
    xd = buf[offset:].view(M, N)
    assert xd.data_ptr() % 16 == 4 * offset
    r1, scale = float(np.float32(3.1e-5)), float(np.float32(scale))
    hi, lo = _launched_once(fused_requant_shiftmax, xd, r1, scale, n_valid, out_bits)
    rhi, rlo = fused_requant_shiftmax_reference(x, r1, scale, n_valid, out_bits)
    torch.testing.assert_close(hi.cpu(), rhi, rtol=0, atol=0)
    torch.testing.assert_close(lo.cpu(), rlo, rtol=0, atol=0)
    if n_valid == 1 and scale == 0.125 and out_bits == 16:
        assert (rhi[:, 0] == 127).all()


# (G, N, hd, heads, mask geometry (res, ws, shift) or None): Swin-T's
# stage-1 batch-1 shape with its shifted-window mask, stage 4 at batch 1
# (unmasked), and a ragged window
WINDOW_CASES = {
    "stage1_masked": (192, 49, 32, 3, (56, 7, 3)),
    "stage4_unmasked": (24, 49, 32, 24, None),
    "ragged_masked": (12, 16, 8, 3, (8, 4, 2)),
}


@pytest.mark.parametrize("case", sorted(WINDOW_CASES))
def test_window_attention_kernel_matches_reference(dev, case):
    G, N, hd, heads, geometry = WINDOW_CASES[case]
    qkv, (r1, scale, r_out) = _attention_case(G, N, hd, 8, seed=G)
    rng = np.random.default_rng(N)
    bias = torch.from_numpy(rng.integers(-30, 31, (heads, N, N)).astype(np.float32))
    mask = None if geometry is None else torch.from_numpy(sw_attn_mask(geometry[0], geometry[0], *geometry[1:]) / np.float32(scale))
    args = (r1, float(np.float32(0.9)), scale, r_out, heads)
    out = _launched_once(fused_int8_window_attention, *(a.to(dev) for a in qkv), bias.to(dev),
                         None if mask is None else mask.to(dev), *args)
    ref = fused_int8_window_attention_reference(*qkv, bias, mask, *args)
    torch.testing.assert_close(out.cpu(), ref, rtol=0, atol=0)
    assert ref.unique().numel() > 20


# Swin-T's stages: heads, and the resolution tiled by 7 x 7 windows
SWIN_T_STAGES = {1: (3, 56), 2: (6, 28), 3: (12, 14), 4: (24, 7)}


def _window_inputs(G, N, hd, heads, mask, scale, low, seed):
    """q, k, v spread over a third of the int8 scores, with cells of tied
    scores (q = 0) and of clipped ones (q = 127 against k = +-127); an
    integer bias; with ``low``, the rows of window 0 that have a masked
    column get bias 127 there and ``low`` elsewhere (at scale 0.45, -100
    puts masked arguments above the clamp, -300 makes a masked score the
    row max)."""
    qkv, (r1, _, r_out) = _attention_case(G, N, hd, 8, seed=seed)
    q, k, _ = qkv
    c = max(G // 8, 1)
    q[1:c] = 0
    q[c:2 * c], k[c:2 * c] = 127, -128
    rng = np.random.default_rng(seed)
    bias = rng.integers(-30, 31, (heads, N, N)).astype(np.float32)
    if low is not None:
        hit = mask[0] != 0
        bias[:] = np.where(hit, 127.0, np.where(hit.any(-1, keepdims=True), low, bias))
    return qkv, torch.from_numpy(bias), (r1, float(np.float32(0.9)), float(np.float32(scale)), r_out)


@pytest.mark.parametrize("batch", [1, 128])
@pytest.mark.parametrize("stage", sorted(SWIN_T_STAGES))
@pytest.mark.parametrize(
    "case", ["unmasked", "masked", "masked_above_clamp", "masked_row_max"],
)
def test_window_attention_kernel_at_swin_t_stages(dev, stage, batch, case):
    """K7 at every Swin-T stage shape (B * nW * heads, 49, 32), batch 128
    and 1, against its plain version on the card: unmasked, masked at a
    Swin-like scale (every masked argument at the clamp), and at a scale
    where masked arguments lie above it and masked scores are row maxima."""
    heads, res = SWIN_T_STAGES[stage]
    G = batch * (res // 7) ** 2 * heads
    scale = 0.07 if case in ("unmasked", "masked") else 0.45
    plane = sw_attn_mask(res, res, 7, 3)
    low = {"masked_above_clamp": -100.0, "masked_row_max": -300.0}.get(case)
    qkv, bias, (r1, rb, scale, r_out) = _window_inputs(G, 49, 32, heads, plane, scale, low, seed=stage + batch)
    mask = None if case == "unmasked" else torch.from_numpy(plane / np.float32(scale))
    args = [a.to(dev) for a in qkv] + [bias.to(dev), None if mask is None else mask.to(dev)]
    out = _launched_once(fused_int8_window_attention, *args, r1, rb, scale, r_out, heads)
    ref = fused_int8_window_attention_reference(*args, r1, rb, scale, r_out, heads)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    assert ref.unique().numel() > 20


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("hd", [4, 32, 256])
@pytest.mark.parametrize("N", [1, 7, 33, 64, 65, 144, 256])
def test_window_attention_kernel_domain(dev, N, hd, masked):
    """K7 over its domain: N from 1 to 256 (the planes in shared memory up
    to 64 tokens, from L2 above) against hd from 4 to 256."""
    heads, n_windows, scale = 2, 2, 0.07
    G = 2 * n_windows * heads
    plane = np.where(np.random.default_rng(N).random((n_windows, N, N)) < 0.3, -100.0, 0.0).astype(np.float32)
    qkv, bias, (r1, rb, scale, r_out) = _window_inputs(G, N, hd, heads, plane, scale, None, seed=N + hd)
    mask = torch.from_numpy(plane / np.float32(scale)) if masked else None
    out = fused_int8_window_attention(*(a.to(dev) for a in qkv), bias.to(dev), None if mask is None else mask.to(dev),
                                      r1, rb, scale, r_out, heads)
    ref = fused_int8_window_attention_reference(*qkv, bias, mask, r1, rb, scale, r_out, heads)
    torch.testing.assert_close(out.cpu(), ref, rtol=0, atol=0)


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("shape", [(24, 49, 32), (12, 16, 8)], ids=_attention_ids)
def test_window_attention_kernel_fractional_bias(dev, shape, masked):
    """A bias that is not integral keeps the merged scores off the
    integers: the kernel's general path (recomputed scores, the chain
    where neither table holds the argument) against the plain version."""
    G, N, hd = shape
    heads, n_windows = 3, 2
    plane = np.where(np.random.default_rng(N).random((n_windows, N, N)) < 0.3, -100.0, 0.0).astype(np.float32)
    qkv, bias, (r1, rb, scale, r_out) = _window_inputs(G, N, hd, heads, plane, 0.07, None, seed=G)
    bias = bias + torch.from_numpy(np.random.default_rng(G).uniform(-0.5, 0.5, bias.shape).astype(np.float32))
    mask = torch.from_numpy(plane / np.float32(scale)) if masked else None
    out = fused_int8_window_attention(*(a.to(dev) for a in qkv), bias.to(dev), None if mask is None else mask.to(dev),
                                      r1, rb, scale, r_out, heads)
    ref = fused_int8_window_attention_reference(*qkv, bias, mask, r1, rb, scale, r_out, heads)
    torch.testing.assert_close(out.cpu(), ref, rtol=0, atol=0)
    assert ref.unique().numel() > 20


# torch._int_mm on CUDA takes K and N that are multiples of 8 only: a
# 100-class head (N = 100) and Swin at patch 2 (the patch embed's K is
# 2 * 2 * 3 = 12) go through the zero-padded weights of carry_linear
@pytest.mark.parametrize("model", ["deit_num_classes_100", "swin_patch_2"])
def test_engines_at_widths_not_multiples_of_8(dev, model):
    if model == "swin_patch_2":
        artifact = synthetic_swin_artifact(
            "swin_tiny", seed=0, img_size=16, patch_size=2, embed_dim=16, depths=(2, 2),
            num_heads=(2, 4), window_size=4, num_classes=8,
        )
        build, size = build_swin_infer, 16
        assert artifact["patch_embed"]["w"].shape == (12, 16)
    else:
        artifact = synthetic_vit_artifact(
            "deit_tiny", seed=1, img_size=32, patch_size=8, embed_dim=128, depth=2, num_heads=2,
            num_classes=100,
        )
        build, size = build_vit_infer, 32
        assert artifact["head"]["w"].shape == (128, 100)
    images = torch.from_numpy(np.random.default_rng(3).standard_normal((3, size, size, 3)).astype(np.float32))
    cpu = build(artifact, "cpu", kernels=())(images)
    for kernels in ((), None):
        infer = build(artifact, dev) if kernels is None else build(artifact, dev, kernels=kernels)
        logits = infer(images)
        torch.testing.assert_close(logits.cpu(), cpu, rtol=0, atol=0)
    assert cpu.shape[1] == artifact["config"]["num_classes"]


# The paths of deploy/graphs.py at a reduced depth: (model, softmax_bits,
# gelu_stable, kernels or None for the engine's default, launches a forward)
GRAPH_PATHS = {
    "main": ("vit", 8, True, None, {"K1": 2, "K3": 5, "K9": 2}),
    "A": ("vit", 16, False, ("layernorm", "attention2", "linear_gelu"), {"K2": 2, "K4": 2, "K3": 5}),
    "B": ("vit", 16, False, ("layernorm", "softmax", "gelu"), {"K6": 2, "K5": 2, "K3": 5}),
    "K1_sm16": ("vit", 16, False, None, {"K1": 2, "K3": 5}),
    "swin": ("swin", None, False, None, {"K7": 4, "K3": 10}),
    "plain": ("vit", 8, True, (), {}),
    "swin_plain": ("swin", None, False, (), {}),
}


def _graph_artifact(path):
    """The tiny seeded artifact of a graph path, its builder and image size."""
    model, bits, stable, _, _ = GRAPH_PATHS[path]
    if model == "swin":
        artifact = synthetic_swin_artifact(
            "swin_tiny", seed=1, img_size=56, patch_size=4, embed_dim=32, depths=(2, 2), num_heads=(2, 4),
            num_classes=16,
        )  # stage 1: 14x14 tokens in 7x7 windows, block 1 shifted; stage 2: one window
        return artifact, build_swin_infer, 56
    artifact = synthetic_vit_artifact(
        "deit_tiny", seed=1, softmax_bits=bits, gelu_stable=stable,
        img_size=32, patch_size=8, embed_dim=128, depth=2, num_heads=2, num_classes=16,
    )
    return artifact, build_vit_infer, 32


def _graph_engine(dev, path):
    artifact, build, size = _graph_artifact(path)
    kernels, counts = GRAPH_PATHS[path][3:]
    infer = build(artifact, dev) if kernels is None else build(artifact, dev, kernels=kernels)
    return infer, size, counts


@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("path", sorted(GRAPH_PATHS))
def test_graph_replay_is_bit_equal_to_eager(dev, path, batch):
    """The eager forward's launches, its logits equal to the plain engine
    on the CPU (tolerance 0), and after its first call no host copy or
    wait in it (what a capture needs); the captured forward's logits
    equal the eager engine's, its launches, counted during the capture,
    are one forward's, and a replay launches nothing through a wrapper."""
    infer, size, counts = _graph_engine(dev, path)
    artifact, build, _ = _graph_artifact(path)
    images = torch.from_numpy(np.random.default_rng(batch).standard_normal((batch, size, size, 3)).astype(np.float32))
    x = images.to(dev)
    eager, launched = count_launches(infer, x)
    assert launched == counts
    torch.testing.assert_close(eager.cpu(), build(artifact, "cpu", kernels=())(images), rtol=0, atol=0)
    assert _host_syncs(lambda: infer(x)) == _host_syncs(lambda: None), path
    graphed = capture_infer(infer, batch, size, dev)
    assert graphed.launches == counts
    before = {name: fn.launches for name, fn in WRAPPERS.items()}
    logits = graphed(images.to(dev))
    torch.cuda.synchronize()
    assert {name: fn.launches for name, fn in WRAPPERS.items()} == before
    torch.testing.assert_close(logits, eager, rtol=0, atol=0)


@pytest.mark.parametrize("path", ["main", "swin"])
def test_marked_graph_times_each_stage_and_equals_the_plain_graph(dev, path):
    """While the profiler records, a replay runs the marked graph (the
    same forward with a timing event at each span's start and end): its
    logits equal the plain graph's bit for bit, and each replay gives one
    sample of positive stage times, one a span of the eager forward.
    With the profiler off the plain graph replays and nothing is
    recorded; ``replay.launches`` counts the plain capture alone."""
    from torch.profiler import ProfilerActivity, profile

    infer, size, counts = _graph_engine(dev, path)
    images = torch.from_numpy(np.random.default_rng(7).standard_normal((2, size, size, 3)).astype(np.float32)).to(dev)
    spans.take()
    with profile(activities=[ProfilerActivity.CPU]):
        infer(images)
    stages = [r.name for r in spans.take().spans]
    before = spans.SETUP_S.get("capture_infer", 0.0)
    graphed = capture_infer(infer, 2, size, dev)
    assert graphed.launches == counts
    assert spans.SETUP_S["capture_infer"] > before
    plain = graphed(images)
    torch.cuda.synchronize()
    assert spans.take().samples == []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        first = graphed(images)
        torch.cuda.synchronize()
        second = graphed(images)  # the first has finished: marked again
        torch.cuda.synchronize()
    samples = spans.take().samples
    assert len(samples) == 2
    for sample in samples:
        assert [name for name, _ in sample] == stages
        assert all(ms > 0 for _, ms in sample)
    for out in (first, second):
        torch.testing.assert_close(out, plain, rtol=0, atol=0)
    torch.testing.assert_close(graphed(images), plain, rtol=0, atol=0)
    torch.cuda.synchronize()
    assert spans.take().samples == []


def test_eager_spans_time_the_device(dev):
    """On the card an eager span's device time comes from its timing
    events; a train step's three phases each read a positive time."""
    model = create_model("deit_tiny", device=dev, img_size=16, patch_size=8, num_classes=8, embed_dim=32, depth=2,
                         num_heads=4)
    state = create_train_state(model, AdamW(1e-3), device=dev)
    step = make_train_step(model)
    images = torch.randn((4, 16, 16, 3), device=dev)
    targets = torch.nn.functional.one_hot(torch.arange(4, device=dev) % 8, 8).to(torch.float32)
    state, _ = step(state, images, targets)
    spans.take()
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        step(state, images, targets)
    records = spans.take().spans
    assert [r.name for r in records] == ["train.forward", "train.backward", "train.optimizer"]
    assert all(r.device_ms > 0 and r.host_ms > 0 for r in records)


def test_graph_logits_do_not_change_at_the_next_call(dev):
    infer, size, _ = _graph_engine(dev, "main")
    rng = np.random.default_rng(5)
    first, second = (torch.from_numpy(rng.standard_normal((2, size, size, 3)).astype(np.float32)).to(dev)
                     for _ in range(2))
    graphed = capture_infer(infer, 2, size, dev)
    out1 = graphed(first)
    kept = out1.clone()
    out2 = graphed(second)
    torch.cuda.synchronize()
    torch.testing.assert_close(out1, kept, rtol=0, atol=0)
    assert not torch.equal(out1, out2)
    torch.testing.assert_close(out2, infer(second), rtol=0, atol=0)


@pytest.mark.parametrize("softmax_bits,gelu_stable", [(8, True), (16, False)])
@pytest.mark.parametrize("model", ["deit_tiny", "deit_small"])
def test_strict_engine_on_card_matches_cpu(dev, model, softmax_bits, gelu_stable):
    """``strict_dyadic`` on the card equals the CPU: a tiny DeiT on three
    images, and DeiT-S at its published width on two."""
    if model == "deit_small":
        artifact = synthetic_vit_artifact("deit_small", seed=0, softmax_bits=softmax_bits, gelu_stable=gelu_stable)
        images = _published_images(2)
    else:
        artifact = synthetic_vit_artifact(
            "deit_tiny", seed=1, softmax_bits=softmax_bits, gelu_stable=gelu_stable,
            img_size=32, patch_size=8, embed_dim=128, depth=2, num_heads=2, num_classes=16,
        )
        images = torch.from_numpy(np.random.default_rng(2).standard_normal((3, 32, 32, 3)).astype(np.float32))
    logits = build_vit_infer(artifact, dev, kernels=(), strict_dyadic=True)(images)
    cpu = build_vit_infer(artifact, "cpu", kernels=(), strict_dyadic=True)(images)
    torch.testing.assert_close(logits.cpu(), cpu, rtol=0, atol=0)


def test_graph_keeps_its_engine_alive(dev):
    """The graph reads the engine's weights in place: the replay function
    keeps them alive when the caller drops the engine (and the allocator
    releases its free memory)."""
    infer, size, _ = _graph_engine(dev, "main")
    images = torch.from_numpy(np.random.default_rng(6).standard_normal((2, size, size, 3)).astype(np.float32)).to(dev)
    eager = infer(images)
    graphed = capture_infer(infer, 2, size, dev)
    del infer
    gc.collect()
    torch.cuda.empty_cache()
    torch.testing.assert_close(graphed(images), eager, rtol=0, atol=0)


# ---- the paths at their published widths and depths ----------------------------------------------

ROUTE_A = ("layernorm", "attention2", "linear_gelu")
ROUTE_B = ("layernorm", "softmax", "gelu")
SM16 = dict(softmax_bits=16, gelu_stable=False)  # the reference spec: 16-bit Shiftmax, row-max ShiftGELU
SM8 = dict(softmax_bits=8, gelu_stable=True)  # the main path
# path: (model, artifact options, kernels or None for the engine's default,
# launches a forward, batch); seeded artifacts (seed 0) at the published
# widths and depths, DeiT-S and Swin-T on the same 128 images
PUBLISHED_PATHS = {
    "deit_s": ("deit_small", SM8, None, {"K1": 12, "K3": 25, "K9": 12}, 128),
    "deit_s16_A": ("deit_small", SM16, ROUTE_A, {"K2": 12, "K4": 12, "K3": 25}, 128),
    "deit_s16_B": ("deit_small", SM16, ROUTE_B, {"K6": 12, "K5": 12, "K3": 25}, 128),
    "deit_s16_K1": ("deit_small", SM16, None, {"K1": 12, "K3": 25}, 128),
    "deit_s_plain": ("deit_small", SM8, (), {}, 128),
    "swin_t": ("swin_tiny", {}, None, {"K7": 12, "K3": 28}, 128),
    "vit_l384": ("vit_large", dict(SM8, img_size=384), None, {"K10": 24, "K3": 49, "K9": 24}, 32),
}


def _published_images(n, size=224):
    """The first ``n`` of the seeded normal images the published paths run on."""
    return torch.from_numpy(np.random.default_rng(1 if size == 224 else 0).standard_normal((n, size, size, 3),
                                                                                            dtype=np.float32))


def _published(path, dev):
    """The seeded artifact of ``path``, its engine on the card and its builder."""
    model, options, kernels, _, _ = PUBLISHED_PATHS[path]
    if model == "swin_tiny":
        artifact, build = synthetic_swin_artifact(model, seed=0, **options), build_swin_infer
    else:
        artifact, build = synthetic_vit_artifact(model, seed=0, **options), build_vit_infer
    infer = build(artifact, dev) if kernels is None else build(artifact, dev, kernels=kernels)
    return artifact, infer, build


def _launched_once(wrapper, *args):
    """A kernel wrapper's output, having launched its kernel once and no
    other."""
    out, counts = count_launches(wrapper, *args)
    assert counts == {name: 1 for name, w in WRAPPERS.items() if w is wrapper}
    return out


def _host_syncs(fn):
    """The host calls that wait on the device inside ``fn()``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
    return sorted(e.name for e in prof.events() if e.device_type == DeviceType.CPU
                  and e.name in ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaMemcpy"))


@pytest.mark.parametrize("path", sorted(PUBLISHED_PATHS))
def test_attention_kernel_by_row_length(dev, path):
    """Each path at its published width and depth, eager and captured as a
    CUDA graph at its batch and at batch 1: the launches of every forward
    (ViT-L/16 at 384², 577 tokens, runs K10 in every block and no K1;
    DeiT-S, 197 tokens, K1 and no K10), the logits equal to ``kernels=()``
    on the card and, for the 224² paths, images 0-1 to the plain engine
    on the CPU (tolerance 0), finite, batch 1 equal to row 0, no host
    synchronisation in a forward, and every replay equal to the eager
    logits, adding no launch."""
    from ivit_tpu_torch.deploy.graphs import FORWARDS

    _, _, _, per_forward, batch = PUBLISHED_PATHS[path]
    artifact, infer, build = _published(path, dev)
    size = artifact["config"]["img_size"]
    images = _published_images(batch, size).to(dev)
    logits, counts = count_launches(infer, images)
    assert counts == per_forward
    assert logits.shape == (batch, artifact["config"]["num_classes"]) and bool(torch.isfinite(logits).all())
    one, counts = count_launches(infer, images[:1])
    assert counts == per_forward
    torch.testing.assert_close(one, logits[:1], rtol=0, atol=0)
    torch.testing.assert_close(logits, build(artifact, dev, kernels=())(images), rtol=0, atol=0)
    if size == 224:
        cpu = build(artifact, "cpu", kernels=())(images[:2].cpu())
        torch.testing.assert_close(logits[:2].cpu(), cpu, rtol=0, atol=0)
    assert _host_syncs(lambda: infer(images)) == _host_syncs(lambda: None), path
    for b in (batch, 1):
        graphed, counts = count_launches(capture_infer, infer, b, size, dev)
        assert counts == {name: FORWARDS * n for name, n in per_forward.items()}
        assert graphed.launches == per_forward
        replay, counts = count_launches(graphed, images[:b])
        assert counts == {}
        torch.testing.assert_close(replay, logits[:b], rtol=0, atol=0)
        del graphed, replay
    torch.cuda.empty_cache()


def _same(out, ref):
    """A kernel's output (or tuple of outputs) equal to its plain
    version's, tolerance 0."""
    for a, b in zip(out if isinstance(out, tuple) else (out,), ref if isinstance(ref, tuple) else (ref,)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def _int8(shape, gen, dev):
    return torch.randint(-128, 128, shape, generator=gen, dtype=torch.int8).to(dev)


def test_kernels_on_the_deit_s_paths_own_inputs(dev):
    """Every ViT kernel against its plain version (tolerance 0) on the
    published DeiT-S paths' own block-0 inputs at batch 128 and 1, and on
    random inputs of the same shapes that spread its values: K3 on the
    norm1 input and the final norm's rows; K1 on the main path's and K1
    and K2 on the sm16 path's q, k, v at out_bits 8 and 16; K6 on the sm16
    scores, also from a row-slice view whose base lies 4 bytes past a
    16-byte boundary; K4 and K5 on the sm16 MLP input and fc1
    accumulator, and the GELU tables of route A's blocks against their
    torch twin; K9 on the main path's fc1 accumulator, also against the
    plain chain the engine runs with ``kernels=()``, and the tables the
    engine filled on the card against the CPU's."""
    from ivit_tpu_torch.deploy.engine import attention_half, attention_inputs, embed, int8_linear
    from ivit_tpu_torch.kernels.attention_fused_v2 import scale_gate
    from ivit_tpu_torch.ops import INT8, requant, shiftgelu

    art8, main, _ = _published("deit_s", dev)
    _, route_a, _ = _published("deit_s16_A", dev)
    t8, t16 = main.tensors, route_a.tensors
    blk8, blk16 = t8["blocks"][0], t16["blocks"][0]
    cfg = t8["config"]
    D, H = cfg["embed_dim"], cfg["num_heads"]
    hd, N, hidden = D // H, (cfg["img_size"] // cfg["patch_size"]) ** 2 + 1, int(D * cfg["mlp_ratio"])
    gen = torch.Generator().manual_seed(0)
    s8 = {k: np.float32(art8["blocks"][0][k]) for k in ("s_attn_qact1", "s_attn_out")}
    spread_r1, spread_scale = float(np.float32(127.0 / (3 * np.sqrt(hd) * 74.0**2))), float(np.float32(0.07))

    def r_out_at(bits):  # the main path's block-0 r_out at this probability width (float32, as the engine forms it)
        return float(np.float32(np.float32(1.0 / 2 ** (bits - 1)) * s8["s_attn_qact1"]) / s8["s_attn_out"])

    def k9_chain(acc, b, r1, table):
        g8 = blk8["gelu"]
        g, _ = shiftgelu(requant(acc + b, r1, *INT8), g8["scale"], out_bits=8, stable=True)
        return requant(g, g8["ratio"], *INT8).to(torch.int8)

    images = _published_images(128).to(dev)
    for x_images in (images, images[:1]):
        with torch.inference_mode():
            x8, x16 = embed(x_images, t8), embed(x_images, t16)
            for rows in (x8.reshape(-1, D), x8[:, 0].contiguous()):
                args = (rows, blk8["norm1"]["bias_int"], blk8["norm1"]["ratio"])
                _same(fused_layernorm_requant(*args), fused_layernorm_requant_reference(*args))
            q8, k8, v8 = attention_inputs(x8, blk8, H)
            q16, k16, v16 = attention_inputs(x16, blk16, H)
            G = q8.shape[0]
            rand = [_int8((G, N, hd), gen, dev) for _ in range(3)]
            a8, a16 = blk8["attn"], blk16["attn"]
            for bits in (8, 16):
                cases = [((q8, k8, v8), a8["r1"], a8["scale"], r_out_at(bits)),
                         (rand, spread_r1, spread_scale, r_out_at(bits))]
                if bits == 16:
                    cases.append(((q16, k16, v16), a16["r1"], a16["scale"], a16["r_out"]))
                for (q, k, v), r1, scale, r_out in cases:
                    _same(fused_int8_attention(q, k, v, r1, scale, r_out, bits),
                          fused_int8_attention_reference(q, k, v, r1, scale, r_out, bits))
                    if scale_gate(N, scale):
                        _same(fused_int8_attention_v2(q, k, v, r1, scale, r_out, N, bits),
                              fused_int8_attention_v2_reference(q, k, v, r1, scale, r_out, N, bits))
            # K6: the sm16 block-0 scores and random ones; the row-slice view
            rq, rk = _int8((G, N, hd), gen, dev), _int8((G, N, hd), gen, dev)
            for (q, k), r1, scale in (((q16, k16), a16["r1"], a16["scale"]), ((rq, rk), spread_r1, spread_scale)):
                x = torch.matmul(q.double(), k.double().transpose(-1, -2)).to(torch.int32).reshape(-1, N)
                _same(fused_requant_shiftmax(x, r1, scale, N), fused_requant_shiftmax_reference(x, r1, scale, N))
                if x.shape[0] > H * N:
                    assert x[1:].data_ptr() % 16 == 4
                    _same(fused_requant_shiftmax(x[1:], r1, scale, N),
                          fused_requant_shiftmax_reference(x[1:], r1, scale, N))
            # K4 and K5: the sm16 block-0 MLP input and fc1 accumulator, and
            # random ones whose per-channel ratios spread the GELU inputs
            fc1, gelu = blk16["fc1"], blk16["gelu"]
            y = fused_layernorm_requant_reference(attention_half(x16, blk16, t16["config"], ()),
                                                  blk16["norm2"]["bias_int"], blk16["norm2"]["ratio"])
            acc = int8_linear(y, fc1)
            M = y.shape[0]
            spread = torch.from_numpy(np.random.default_rng(M).uniform(0.5, 2.0, hidden).astype(np.float32)).to(dev)
            racc = torch.randint(-(2**20), 2**20, (M, hidden), generator=gen, dtype=torch.int32).to(dev)
            racc[0] = -racc[0].abs() - 1  # an all-negative row: e_max saturates
            for args in ((y, fc1["w_t"].T, fc1["b"], fc1["ratio"], gelu["s_in"], gelu["r2"]),
                         (_int8((M, D), gen, dev), fc1["w_t"].T, fc1["b"],
                          spread * float(40.0 / (74.0**2 * np.sqrt(D))), gelu["s_in"], gelu["r2"])):
                _same(fused_linear_shiftgelu(*args), fused_linear_shiftgelu_reference(*args))
            for args in ((acc, fc1["ratio"], gelu["s_in"], gelu["r2"]),
                         (racc, spread * 1e-4, gelu["s_in"], gelu["r2"])):
                _same(fused_requant_shiftgelu(*args), fused_requant_shiftgelu_reference(*args))
            # K9: the main path's block-0 fc1 accumulator and random ones
            y8 = fused_layernorm_requant_reference(attention_half(x8, blk8, cfg, ()),
                                                   blk8["norm2"]["bias_int"], blk8["norm2"]["ratio"])
            acc9 = int8_linear(y8, blk8["fc1"], bias=False)
            rr1 = torch.from_numpy((np.random.default_rng(M).uniform(0.5, 2.0, hidden) * 1e-4).astype(np.float32))
            racc9 = torch.randint(-(2**20), 2**20, (M, hidden), generator=gen, dtype=torch.int32).to(dev)
            table = blk8["gelu"]["table"]
            own = (acc9, blk8["fc1"]["b"], blk8["fc1"]["ratio"], table)
            out9 = fused_requant_stable_gelu(*own)
            _same(out9, fused_requant_stable_gelu_reference(*own))
            _same(out9, k9_chain(*own))
            rand9 = (racc9, blk8["fc1"]["b"], rr1.to(dev), table)
            _same(fused_requant_stable_gelu(*rand9), fused_requant_stable_gelu_reference(*rand9))
    for s_in, r2 in sorted({(b["gelu"]["s_in"], b["gelu"]["r2"]) for b in t16["blocks"]}):
        _same(gelu_table_on(dev, s_in, r2), gelu_table(s_in, r2).to(dev))
    for blk in t8["blocks"]:
        g = blk["gelu"]
        _same(g["table"], stable_gelu_table(g["scale"].cpu(), g["ratio"].cpu()).to(dev))


def test_kernels_on_the_swin_t_paths_own_inputs(dev):
    """K3 and K7 against their plain versions (tolerance 0) on the
    published Swin-T path's own inputs at batch 128 and 1: K3 on each
    stage's first norm input and each patch merging's; K7 on every
    stage's block 0 (unshifted) and block 1 (shifted, masked in stages
    1-3) q, k, v, and on random q, k, v of the same shapes."""
    from ivit_tpu_torch.deploy.swin_engine import merge_gather, patch_embed, swin_trunk, window_attention_inputs

    _, swin, _ = _published("swin_t", dev)
    ts = swin.tensors
    where = {}
    for i, st in enumerate(ts["stages"]):
        where.update({id(b): (i, j) for j, b in enumerate(st["blocks"])})
        if "downsample" in st:
            where[id(st["downsample"])] = (i, "merge")
    gen = torch.Generator().manual_seed(0)
    spread_r1 = float(np.float32(127.0 / (3 * np.sqrt(32) * 74.0**2)))
    images = _published_images(128).to(dev)
    for x_images in (images, images[:1]):
        norms, windows = [], []

        def visit(layer, x):
            i, j = where[id(layer)]
            if j == "merge":
                norms.append((merge_gather(x, layer["res"]), layer["norm"]))
                return
            if j == 0:
                norms.append((x.reshape(-1, x.shape[-1]), layer["norm1"]))
            if j < 2:
                windows.append((layer, window_attention_inputs(x, layer, kernels=())))

        with torch.inference_mode():
            swin_trunk(patch_embed(x_images, ts), ts, (), on_layer=visit)
            for x, norm in norms:
                args = (x, norm["bias_int"], norm["ratio"])
                _same(fused_layernorm_requant(*args), fused_layernorm_requant_reference(*args))
            assert sum(blk["attn"]["mask"] is not None for blk, _ in windows) == 3
            for blk, (q, k, v) in windows:
                a, heads = blk["attn"], blk["heads"]
                rand = [_int8(q.shape, gen, dev) for _ in range(3)]
                for (qq, kk, vv), r1 in (((q, k, v), a["r1"]), (rand, spread_r1)):
                    args = (qq, kk, vv, a["bias"], a["mask"], r1, a["rb"], a["scale"], a["r_out"], heads)
                    _same(fused_int8_window_attention(*args), fused_int8_window_attention_reference(*args))


def _real_scale_artifact(a):
    """``a`` with its biases, class token and position embedding at the
    real values they stand for (the integers times their scales). The FP32
    benchmark leg feeds the raw integers (its timing does not depend on
    the values), under which its logits are the head's integer bias plus
    terms below that bias's float32 spacing; at real values the leg is a
    well-conditioned forward, on which TF32 shows."""
    a = copy.deepcopy(a)
    for layer in [a["patch_embed"], a["head"]] + [blk[k] for blk in a["blocks"] for k in ("qkv", "proj", "fc1", "fc2")]:
        layer["b"] = (layer["b"].astype(np.float32) * layer["out_scale"]).astype(np.float32)
    a["pos_q"] = (a["pos_q"] * a["pos_scale"]).astype(np.float32)
    a["cls_q"] = (a["cls_q"] * a["embed_scale"]).astype(np.float32)
    return a


def test_bench_fp32_leg_on_card_matches_cpu(dev):
    """The serving bench's true-FP32 DeiT-S leg at batch 2 on the
    published main path's weights at real scale: with TF32 off, within
    4e-6 of the largest |logit| of the CPU's (float32 products summed in
    other orders); with TF32 on it misses that bound, so the bound tells
    the two apart."""
    from ivit_tpu_torch import bench

    art = _real_scale_artifact(synthetic_vit_artifact("deit_small", seed=0, **SM8))
    images = _published_images(2)
    card = bench._float_vit_infer(art, dev)
    bench.assert_fp32_highest()
    try:
        fp32 = card(images.to(dev)).cpu()
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        tf32 = card(images.to(dev)).cpu()
    finally:
        bench.fp32_highest()
    cpu = bench._float_vit_infer(art, "cpu")(images)
    tol = 4e-6 * float(cpu.abs().max())
    assert float((fp32 - cpu).abs().max()) <= tol
    assert float((tf32 - cpu).abs().max()) > tol


def test_reference_checkpoint_serves_on_the_card(dev, tmp_path):
    """A reference-style DeiT-S checkpoint (the published main path's
    integers and scales) through ``convert_model --torch-checkpoint``,
    then the default kernels on the card: 12 K1 + 25 K3 + 12 K9 a
    forward, the logits of two images equal to the plain engine's on the
    CPU (tolerance 0)."""
    from ivit_tpu_torch import convert_model
    from ivit_tpu_torch.utils import load_artifact

    state = vit_state(synthetic_vit_artifact("deit_small", seed=0, **SM8))
    ckpt, out = str(tmp_path / "checkpoint.pth.tar"), str(tmp_path / "artifact.pkl")
    torch.save({"model": {k: torch.from_numpy(np.array(v)) for k, v in state.items()}}, ckpt)
    convert_model.main(["--model", "deit_small", "--torch-checkpoint", ckpt, "--softmax-bits", "8", "--gelu-stable",
                        "--output", out])
    artifact = load_artifact(out)
    images = _published_images(2)
    logits, counts = count_launches(build_vit_infer(artifact, dev), images.to(dev))
    assert counts == {"K1": 12, "K3": 25, "K9": 12}
    torch.testing.assert_close(logits.cpu(), build_vit_infer(artifact, "cpu", kernels=())(images), rtol=0, atol=0)


def _python_m(module, *args):
    """``python -m module args`` from the repository root, as a user runs
    it: exit 0; its output."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    run = subprocess.run([sys.executable, "-m", module, *args], cwd=repo, capture_output=True, text=True,
                         timeout=900)
    assert run.returncode == 0, run.stderr[-4000:]
    return run.stdout


# the serving entry points as a user runs them: (module and arguments, the
# launches a forward its last lines report; None for the bench's JSON line)
SERVING_CLIS = {
    "bench": (["ivit_tpu_torch.bench"], None),
    "latency_deit_s": (["ivit_tpu_torch.evaluate_latency", "--softmax-bits", "8", "--gelu-stable"],
                       {"K1": 12, "K3": 25, "K9": 12}),
    "latency_swin_t": (["ivit_tpu_torch.evaluate_latency", "--model", "swin_tiny"], {"K7": 12, "K3": 28}),
}


@pytest.mark.parametrize("cli", sorted(SERVING_CLIS))
def test_serving_cli_runs_on_the_card(dev, cli):
    """``python -m ivit_tpu_torch.bench`` (one JSON line with ``bench.py``'s
    keys, each number finite and positive) and ``python -m
    ivit_tpu_torch.evaluate_latency`` (the JAX CLI's last line and the
    launches of a captured forward), each run from the repository root as
    a user runs it, exit 0."""
    args, per_forward = SERVING_CLIS[cli]
    out = _python_m(*args)
    lines = out.strip().splitlines()
    if per_forward is None:
        result = json.loads(lines[-1])
        assert set(result) == {"metric", "value", "unit", "vs_baseline"}
        assert all(math.isfinite(result[k]) and result[k] > 0 for k in ("value", "vs_baseline")), result
    else:
        assert re.match(r"^\S+ int8 batch=1: [0-9.]+ ms/iter, [0-9.]+ img/s$", lines[-1]), lines[-1]
        captured = re.search(r"launches a forward (\{.*\})", out)
        assert captured is not None and ast.literal_eval(captured.group(1)) == per_forward, out[-2000:]


# the QAT trainer on the card: the tiny model of tests/test_torch_qat_model.py
QAT_TINY = dict(img_size=16, patch_size=8, num_classes=8, embed_dim=32, depth=2, num_heads=4)
QAT_GRAD_RTOL = 1e-5  # of each leaf's largest entry: float32 sums in other orders


def _qat_batches(n, seed=0):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        x = rng.standard_normal((4, 16, 16, 3)).astype(np.float32)
        t = np.full((4, 8), 0.1 / 8, np.float32)
        t[np.arange(4), rng.integers(0, 8, 4)] += 0.9
        yield torch.from_numpy(x), torch.from_numpy(t)


@contextlib.contextmanager
def _module_trace(model):
    """Record, in the order they run, every submodule's output (a
    tensor, or a QTensor's integers and scale) with its range buffers
    where it has them, copied to the host; for a ``QuantLinear`` also the
    exact float64 product of its integer input and weight plus its bias,
    the value its output must hold."""
    from ivit_tpu_torch.core.quantizers import weight_scale
    from ivit_tpu_torch.core.ste import quantize
    from ivit_tpu_torch.nn.quant import QuantLinear

    trace = []

    def hook(mod, args, out):
        leaves = [out.q, out.scale] if isinstance(out, QTensor) else [out] if torch.is_tensor(out) else []
        leaves += [b for b in (getattr(mod, "min_val", None), getattr(mod, "max_val", None)) if b is not None]
        exact = None
        if isinstance(mod, QuantLinear):
            with torch.no_grad():
                w_scale = weight_scale(mod.kernel.T, mod.weight_bits)
                w = quantize(mod.kernel, w_scale, mod.weight_bits).cpu().double()
                exact = args[0].q.detach().cpu().double() @ w
                if mod.bias is not None:
                    b = quantize(mod.bias, w_scale * args[0].scale.detach(), mod.bias_bits)
                    exact = exact + b.cpu().double()
        trace.append((mod_names[mod], [v.detach().cpu().clone() for v in leaves], exact))

    mod_names = {m: n or "<model>" for n, m in model.named_modules()}
    handles = [m.register_forward_hook(hook) for m in model.modules()]
    try:
        yield trace
    finally:
        for h in handles:
            h.remove()


def _first_divergence(card_trace, cpu_trace):
    """The first module whose output or range differs between two traces
    of one forward, with the largest difference and the (row, column)
    entries that differ; for a ``QuantLinear``, which side's product
    misses the exact one. None where none differs."""
    for (name, a, exact_card), (_, b, exact_cpu) in zip(card_trace, cpu_trace):
        for k, (u, v) in enumerate(zip(a, b)):
            if not torch.equal(u, v):
                where = (u != v).reshape(-1, u.shape[-1]).nonzero().tolist() if u.dim() else []
                msg = (f"{name} leaf {k} (q, scale, min_val, max_val) differs first: max_abs_err "
                       f"{float((u.double() - v.double()).abs().max())} over {int((u != v).sum())} of {u.numel()} "
                       f"at (row, column) {where[:40]}")
                if exact_card is not None and k == 0:
                    msg += (f"; against the exact product of each side's own input: card "
                            f"{'equal' if torch.equal(u.double(), exact_card) else 'DIFFERS'}, CPU "
                            f"{'equal' if torch.equal(v.double(), exact_cpu) else 'DIFFERS'}; inputs equal "
                            f"{torch.equal(exact_card, exact_cpu)}")
                return msg
    return None


@pytest.mark.parametrize("softmax_bits,gelu_stable", [(16, False), (8, False), (8, True)])
def test_qat_train_forward_on_card_matches_cpu(dev, softmax_bits, gelu_stable):
    """Two train-mode forwards (the ranges assigned, then moved): logits,
    loss and every range bit-equal to the CPU; the parameter gradients
    within QAT_GRAD_RTOL of each leaf's largest entry. The int8 dots of
    this small model go through int8_matmul's row padding."""
    kw = dict(softmax_bits=softmax_bits, gelu_stable=gelu_stable, **QAT_TINY)
    card, cpu = create_model("deit_tiny", device=dev, **kw), create_model("deit_tiny", device="cpu", **kw)
    for i, (x, t) in enumerate(_qat_batches(2)):
        with _module_trace(card) as tc, _module_trace(cpu) as th:
            lc, lh = card(x.to(dev), train=True), cpu(x, train=True)
        where = _first_divergence(tc, th)
        assert where is None, f"forward {i}: {where}"
        torch.testing.assert_close(lc.detach().cpu(), lh.detach(), rtol=0, atol=0)
        for (name, a), (_, b) in zip(card.named_buffers(), cpu.named_buffers()):
            assert torch.equal(a.cpu(), b), name
        loss_c, loss_h = soft_target_cross_entropy(lc, t.to(dev)), soft_target_cross_entropy(lh, t)
        assert loss_c.item() == loss_h.item()
    gc = torch.autograd.grad(loss_c, list(card.parameters()), materialize_grads=True)
    gh = torch.autograd.grad(loss_h, list(cpu.parameters()), materialize_grads=True)
    for (name, _), a, b in zip(cpu.named_parameters(), gc, gh):
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=QAT_GRAD_RTOL * float(b.abs().max()), msg=name)


def test_qat_optimizer_on_card_matches_cpu(dev):
    """AdamW (optax's order, weight decay, a schedule) on the same
    parameters and gradients on the card and the CPU: three updates
    within 8 float32 ulps of each parameter, or 1e-6 of the learning rate
    where an update cancels the parameter (a scalar division on the card
    is a reciprocal multiply, an ulp off the CPU's quotient)."""
    from ivit_tpu_torch.train import cosine_schedule

    rng = np.random.default_rng(4)
    params = [torch.from_numpy(rng.normal(0, 0.02, s).astype(np.float32)) for s in ((96, 32), (32,), (7, 3, 5))]
    grads = [[torch.from_numpy(rng.normal(0, 1e-3, p.shape).astype(np.float32)) for p in params] for _ in range(3)]
    tx = AdamW(cosine_schedule(1e-3, 2, 3, warmup_epochs=1, warmup_lr=1e-4), weight_decay=0.05)
    on_card = [p.to(dev) for p in params]
    s_card, s_cpu = tx.init(on_card), tx.init(params)
    for g in grads:
        tx.update(on_card, [t.to(dev) for t in g], s_card)
        tx.update(params, g, s_cpu)
    for a, b in zip(on_card, params):
        torch.testing.assert_close(a.cpu(), b, rtol=2.0**-20, atol=1e-6 * 1e-3)


def test_qat_train_steps_on_card(dev):
    """Three train steps with the EMA (drop-path 0): the first step's loss
    equal to the CPU's (the forward is bit-equal), every loss finite,
    every range set (min < max)."""
    states, steps = [], []
    for d in (dev, "cpu"):
        m = create_model("deit_tiny", device=d, **QAT_TINY)
        states.append(create_train_state(m, AdamW(1e-3, weight_decay=0.05), ema_decay=0.9, device=d))
        steps.append(make_train_step(m, ema_decay=0.9))
    for i, (x, t) in enumerate(_qat_batches(3, seed=1)):
        (_, met), (_, met_h) = (step(s, x.to(s.model.cls_token.device), t.to(s.model.cls_token.device))
                                for s, step in zip(states, steps))
        assert np.isfinite(met["loss"].item()) and np.isfinite(met_h["loss"].item())
        if i == 0:
            assert met["loss"].item() == met_h["loss"].item()
    ranges = dict(states[0].model.named_buffers())
    for name, b in ranges.items():
        if name.endswith("min_val"):
            assert b.item() < ranges[name[:-7] + "max_val"].item(), name


def test_qat_freeze_serves_route_a_on_card(dev):
    """A model trained on the card, frozen there: the artifact equals the
    one frozen from the same variables on the CPU, and route A (12 K2 +
    12 K4 + 25 K3 at DeiT-S depth; depth, depth and 2·depth + 1 here)
    serves it bit-equal to the plain engine on the CPU."""
    m = create_model("deit_tiny", device=dev, **QAT_TINY)
    state = create_train_state(m, AdamW(1e-3), ema_decay=0.9, device=dev)
    step = make_train_step(m, ema_decay=0.9)
    for x, t in _qat_batches(2, seed=2):
        step(state, x.to(dev), t.to(dev))
    from ivit_tpu_torch.models.model_utils import eval_variables

    art = freeze_vit(m, eval_variables(state), device=dev)
    art_cpu = freeze_vit(m, eval_variables(state), device="cpu")
    for key in ("input_scale", "embed_scale", "head_in_scale", "cls_q", "pos_q"):
        np.testing.assert_array_equal(art[key], art_cpu[key], err_msg=key)
    for blk, blk_cpu in zip(art["blocks"], art_cpu["blocks"]):
        for name in ("qkv", "proj", "fc1", "fc2"):
            for k in ("w", "b", "out_scale"):
                np.testing.assert_array_equal(blk[name][k], blk_cpu[name][k], err_msg=f"{name}.{k}")
    images = torch.from_numpy(np.random.default_rng(3).standard_normal((40, 16, 16, 3)).astype(np.float32))
    infer = build_vit_infer(art, dev, kernels=ROUTE_A)
    logits, counts = count_launches(infer, images.to(dev))
    depth = QAT_TINY["depth"]
    assert counts == {"K2": depth, "K4": depth, "K3": 2 * depth + 1}
    torch.testing.assert_close(logits.cpu(), build_vit_infer(art_cpu, "cpu", kernels=())(images), rtol=0, atol=0)



# the Swin QAT trainer on the card: full Swin-T for one step, config (b) of
# tests/test_torch_qat_swin.py (window 7 over a 14 x 14 grid, L = 49) for
# training, freezing and serving
QAT_SWIN_TINY = dict(img_size=28, patch_size=2, num_classes=8, embed_dim=16, depths=(2, 2), num_heads=(2, 4),
                     window_size=7)


@pytest.mark.parametrize("name", ["deit_small", "swin_tiny"])
def test_qat_step_at_published_width_on_card_matches_cpu(dev, name):
    """One train-mode step of DeiT-S and of Swin-T at full width and
    depth, batch 2, drop-path 0, smoothed one-hot targets: logits, loss
    and every range bit-equal to the CPU; every parameter gradient within
    QAT_GRAD_RTOL of its leaf's largest entry; every bias table's
    gradient nonzero. DeiT-S's GEMMs take ``torch._int_mm`` unpadded."""
    from ivit_tpu_torch.train.augment import one_hot_smooth

    card = create_model(name, device=dev, drop_path_rate=0.0)
    cpu = create_model(name, device="cpu", drop_path_rate=0.0)
    rng = np.random.default_rng(8 if name == "swin_tiny" else 7)
    x = torch.from_numpy(rng.standard_normal((2, 224, 224, 3)).astype(np.float32))
    t = one_hot_smooth(torch.from_numpy(rng.integers(0, 1000, 2)), 1000, 0.1)
    with _module_trace(card) as tc, _module_trace(cpu) as th:
        lc, lh = card(x.to(dev), train=True), cpu(x, train=True)
    where = _first_divergence(tc, th)
    assert where is None, where
    torch.testing.assert_close(lc.detach().cpu(), lh.detach(), rtol=0, atol=0)
    for (name, a), (_, b) in zip(card.named_buffers(), cpu.named_buffers()):
        assert torch.equal(a.cpu(), b), name
    loss_c, loss_h = soft_target_cross_entropy(lc, t.to(dev)), soft_target_cross_entropy(lh, t)
    assert loss_c.item() == loss_h.item()
    gc = torch.autograd.grad(loss_c, list(card.parameters()), materialize_grads=True)
    gh = torch.autograd.grad(loss_h, list(cpu.parameters()), materialize_grads=True)
    for (name, _), a, b in zip(cpu.named_parameters(), gc, gh):
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=QAT_GRAD_RTOL * float(b.abs().max()), msg=name)
        if name.endswith("relative_position_bias_table"):
            assert a.abs().max() > 0, name


@pytest.mark.parametrize("batch", [16, 64])
@pytest.mark.parametrize("use_cutmix", [False, True], ids=["mixup", "cutmix"])
def test_mixup_cutmix_on_card_matches_cpu(dev, use_cutmix, batch):
    """The mixup/cutmix arithmetic on the card and on the CPU from the same
    draws at 224², at batch 16 and at the trainer's 64: images and soft
    targets bit-equal, on each branch."""
    from ivit_tpu_torch.train import MixupConfig
    from ivit_tpu_torch.train.augment import apply_mixup, draw_mixup

    cfg = MixupConfig()
    rng = np.random.default_rng(9)
    images = torch.from_numpy(rng.standard_normal((batch, 224, 224, 3)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 1000, batch))
    draws = draw_mixup(cfg, 224, 224, rng)._replace(use_cutmix=use_cutmix)
    (ic, tc), (ih, th) = apply_mixup(images.to(dev), labels.to(dev), cfg, draws), apply_mixup(images, labels, cfg, draws)
    torch.testing.assert_close(ic.cpu(), ih, rtol=0, atol=0)
    torch.testing.assert_close(tc.cpu(), th, rtol=0, atol=0)


def test_qat_swin_freeze_serves_on_card(dev):
    """A Swin trained on the card with mixup/cutmix targets (every loss
    finite, every range set), frozen there: the artifact equals the one
    frozen from the same variables on the CPU, and the default kernels
    (one K7 a block; two K3 a block, one a patch merging and the final
    norm) serve it bit-equal to the plain engine on the CPU, each kernel
    equal to its plain version on the trained model's own inputs."""
    from ivit_tpu_torch.deploy.swin_engine import freeze_swin
    from ivit_tpu_torch.models.model_utils import eval_variables
    from ivit_tpu_torch.train import MixupConfig, mixup_cutmix

    m = create_model("swin_tiny", device=dev, **QAT_SWIN_TINY)
    state = create_train_state(m, AdamW(1e-3), ema_decay=0.9, device=dev)
    step = make_train_step(m, ema_decay=0.9)
    rng = np.random.default_rng(10)
    gen = torch.Generator(device=dev).manual_seed(0)
    for _ in range(2):
        x = torch.from_numpy(rng.standard_normal((4, 28, 28, 3)).astype(np.float32))
        y = torch.from_numpy(rng.integers(0, 8, 4))
        _, metrics = step(state, *mixup_cutmix(x, y, MixupConfig(num_classes=8), rng, device=dev), gen)
        assert np.isfinite(metrics["loss"].item())
    ranges = dict(m.named_buffers())
    for name, b in ranges.items():
        if name.endswith("min_val"):
            assert b.item() < ranges[name[:-7] + "max_val"].item(), name
    art = freeze_swin(m, eval_variables(state), device=dev)
    art_cpu = freeze_swin(m, eval_variables(state), device="cpu")

    def walk(a, b, path):
        if isinstance(b, dict):
            for k in b:
                walk(a[k], b[k], f"{path}.{k}")
        elif isinstance(b, list):
            for i, (u, v) in enumerate(zip(a, b)):
                walk(u, v, f"{path}[{i}]")
        elif b is not None:
            np.testing.assert_array_equal(a, b, err_msg=path)

    walk(art, art_cpu, "")
    images = torch.from_numpy(np.random.default_rng(11).standard_normal((40, 28, 28, 3)).astype(np.float32))
    infer = build_swin_infer(art, dev)
    logits, counts = count_launches(infer, images.to(dev))
    blocks, stages = sum(QAT_SWIN_TINY["depths"]), len(QAT_SWIN_TINY["depths"])
    assert counts == {"K7": blocks, "K3": 2 * blocks + stages}
    torch.testing.assert_close(logits.cpu(), build_swin_infer(art_cpu, "cpu", kernels=())(images), rtol=0, atol=0)
    _kernels_on_artifact(art, images.to(dev), dev)


# the trainer at the published widths: quant_train.py's defaults (lr and
# warm-up lr 1e-6, weight decay 1e-4, drop path 0.1, label smoothing 0.1,
# EMA decay 0.99996; mixup/cutmix for Swin-T) at batch 64 for six steps;
# the route served and the head output scales its logits may lie off SIM
TRAINED_SERVE = {"deit_small": (ROUTE_A, {"K2": 12, "K4": 12, "K3": 25}, 3),
                 "swin_tiny": (None, {"K7": 12, "K3": 28}, 4)}


@pytest.mark.parametrize("name", sorted(TRAINED_SERVE))
def test_qat_trained_at_published_width_serves_on_card(dev, name):
    """DeiT-S and Swin-T at full width and depth trained on the card for
    six steps at batch 64 (AdamW on a cosine schedule, the EMA; DeiT-S on
    smoothed one-hot targets, Swin-T on mixup/cutmix): every loss finite,
    every range set (min < max). The EMA weights frozen on the card and
    served at batch 128, DeiT-S by route A, Swin-T by K7 + K3: the
    launches a forward, images 0-1 equal to the plain engine on the CPU
    (tolerance 0), the logits within 3 (DeiT-S) or 4 (Swin-T: the engine
    pre-rounds the bias that SIM merges) head output scales of the SIM
    eval forward on the card, the argmax equal (Swin-T: on every row whose
    top two SIM logits lie more than 8 head scales apart); for Swin-T the
    kernels on the trained model's own inputs, its first shifted block's
    among them, equal to their plain versions."""
    from ivit_tpu_torch.deploy.swin_engine import freeze_swin
    from ivit_tpu_torch.models.model_utils import eval_variables
    from ivit_tpu_torch.train import MixupConfig, cosine_schedule, mixup_cutmix
    from ivit_tpu_torch.train.augment import one_hot_smooth

    swin = name == "swin_tiny"
    rng = np.random.default_rng(8 if swin else 7)
    model = create_model(name, device=dev, drop_path_rate=0.1)
    sched = cosine_schedule(1e-6, 6, 1, warmup_epochs=0, warmup_lr=1e-6)
    state = create_train_state(model, AdamW(sched, weight_decay=1e-4), ema_decay=0.99996, device=dev)
    step = make_train_step(model, ema_decay=0.99996)
    gen = torch.Generator(device=dev).manual_seed(0)
    losses = []
    for _ in range(6):
        x = torch.from_numpy(rng.standard_normal((64, 224, 224, 3), dtype=np.float32)).to(dev)
        labels = torch.from_numpy(rng.integers(0, 1000, 64))
        if swin:
            x, t = mixup_cutmix(x, labels.to(dev), MixupConfig(), rng, device=dev)
        else:
            t = one_hot_smooth(labels, 1000, 0.1).to(dev)
        losses.append(step(state, x, t, gen)[1]["loss"].item())
    assert all(math.isfinite(v) for v in losses), losses
    ranges = dict(model.named_buffers())
    assert not [n for n in ranges if n.endswith("min_val") and not ranges[n] < ranges[n[:-7] + "max_val"]]
    variables = eval_variables(state)
    art = (freeze_swin if swin else freeze_vit)(model, variables, device=dev)
    del state, step
    torch.cuda.empty_cache()
    kernels, per_forward, head_scales = TRAINED_SERVE[name]
    build = build_swin_infer if swin else build_vit_infer
    infer = build(art, dev) if kernels is None else build(art, dev, kernels=kernels)
    images = torch.from_numpy(rng.standard_normal((128, 224, 224, 3), dtype=np.float32))
    logits, counts = count_launches(infer, images.to(dev))
    assert counts == per_forward
    torch.testing.assert_close(logits[:2].cpu(), build(art, "cpu", kernels=())(images[:2]), rtol=0, atol=0)
    with torch.no_grad():
        sim = torch.func.functional_call(model, {**variables["params"], **variables["quant_stats"]},
                                         (images.to(dev),), {"train": False})
    head = float(np.max(art["head"]["out_scale"]))
    assert float((logits - sim).abs().max()) <= head_scales * head
    top2 = sim.topk(2, dim=-1).values
    rows = (top2[:, 0] - top2[:, 1]) > 8 * head if swin else slice(None)
    assert torch.equal(logits.argmax(-1)[rows], sim.argmax(-1)[rows])
    if swin:
        _kernels_on_artifact(art, images.to(dev), dev)


def _kernels_on_artifact(art, images, dev):
    """A trained artifact's kernels against their plain versions
    (tolerance 0) on its own inputs (K3 and K1 on a ViT's block 0; K3 on a
    Swin's first block and K7 on each stage's first two, a shifted one
    among them), and its kernel engine's logits equal to the plain
    engine's."""
    swin = "depths" in art["config"]
    build = build_swin_infer if swin else build_vit_infer
    infer = build(art, dev)
    with torch.inference_mode():
        errs = (swin_kernel_errors if swin else vit_kernel_errors)(infer, images)
        torch.testing.assert_close(infer(images), build(art, dev, kernels=())(images), rtol=0, atol=0)
    assert all(e == 0 for e in errs.values()) and (not swin or any("masked" in k for k in errs)), errs


@pytest.mark.parametrize("M,K,N", [(1960, 64, 32), (799, 120, 256), (17, 8, 32), (24, 16, 8), (17, 128, 40),
                                   (1000, 96, 288),
                                   # the zoo's GEMMs at the CLIs' row counts: DeiT-S qkv at batch 64 x 197,
                                   # fc2 at 96 x 197, the head at the last validation batch of 32 and at 5
                                   # rows, Swin-T's patch embed at 32 x 3136 and at 5 rows, a Swin-B merge
                                   # at 48 x 784, ViT-L's fc2 at 128 x 197
                                   (12608, 384, 1152), (18912, 1536, 384), (32, 384, 1000), (5, 768, 1000),
                                   (100352, 48, 96), (5, 48, 96), (37632, 512, 256), (25216, 4096, 1024)])
def test_int8_matmul_pads_rows_int_mm_refuses(dev, M, K, N):
    """``ops.intmm.int8_matmul`` exact at row counts that ``torch._int_mm``
    refuses on the card (below K = 128 every M that is not a multiple of
    32, at N of 32 or more; 16 rows or fewer at any K), at shapes it takes
    as they are, and at the zoo's GEMM widths at the CLIs' row counts
    (``scripts/torch_int_mm_domain.py`` sweeps them all)."""
    from ivit_tpu_torch.ops.intmm import int8_matmul

    rng = np.random.default_rng(M + K + N)
    x = torch.from_numpy(rng.integers(-128, 128, (M, K)).astype(np.int8)).to(dev)
    w = torch.from_numpy(rng.integers(-128, 128, (K, N)).astype(np.int8)).to(dev)
    # float64 products and sums of int8 values are exact (below 2^53)
    exact = (x.to(torch.float64) @ w.to(torch.float64)).to(torch.int32)
    torch.testing.assert_close(int8_matmul(x, w), exact, rtol=0, atol=0)


def test_int8_matmul_exact_at_the_zoo_widths(dev):
    """``ops.intmm.int8_matmul`` exact against float64 at every GEMM of the
    registry's models, at every row count the CLIs give it
    (``scripts/torch_int_mm_domain.py``'s ``zoo_gemms`` and
    ``CLI_BATCHES``; the script sweeps every M to 2,048 as well)."""
    from ivit_tpu_torch.ops.intmm import int8_matmul

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts",
                        "torch_int_mm_domain.py")
    spec = importlib.util.spec_from_file_location("torch_int_mm_domain", path)
    domain = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(domain)
    gen = torch.Generator(device=dev).manual_seed(0)
    bad = []
    for (K, N), tokens in sorted(domain.zoo_gemms().items()):
        w = torch.randint(-128, 128, (K, N), generator=gen, dtype=torch.int8, device=dev)
        rows = sorted({b * t for b in domain.CLI_BATCHES for t in tokens})
        x = torch.randint(-128, 128, (rows[-1], K), generator=gen, dtype=torch.int8, device=dev)
        exact = (x.to(torch.float64) @ w.to(torch.float64)).to(torch.int32)
        bad += [(M, K, N) for M in rows if not torch.equal(int8_matmul(x[:M], w), exact[:M])]
    assert not bad


def test_int8_matmul_exact_after_graph_capture_and_churn(dev):
    """The patch-embed GEMM of the tiny QAT model (16 x 192 @ 192 x 32,
    padded to 17 rows) and its neighbours exact against float64, 100
    times each, after an engine's CUDA graph was captured, replayed and
    dropped and the allocator's freed blocks were refilled with noise:
    the state of the process in which the one named mismatch of
    ``test_qat_train_forward_on_card_matches_cpu`` showed
    (``ROADMAP.md`` §3)."""
    from ivit_tpu_torch.ops.intmm import int8_matmul

    art = synthetic_vit_artifact("deit_tiny", seed=1, img_size=32, patch_size=8, embed_dim=64, depth=2,
                                 num_heads=4, num_classes=16)
    infer = build_vit_infer(art, dev)
    images = torch.from_numpy(np.random.default_rng(6).standard_normal((2, 32, 32, 3)).astype(np.float32)).to(dev)
    graphed = capture_infer(infer, 2, 32, dev)
    torch.testing.assert_close(graphed(images), infer(images), rtol=0, atol=0)
    del graphed, infer
    gc.collect()
    torch.cuda.empty_cache()
    rng = np.random.default_rng(9)
    for rep in range(100):
        noise = [torch.randint(-128, 128, (int(n),), dtype=torch.int8, device=dev) for n in rng.integers(1, 1 << 20, 8)]
        del noise
        for M, K, N in ((16, 192, 32), (4, 192, 32), (16, 32, 128), (16, 128, 32), (17, 192, 32)):
            x = torch.from_numpy(rng.integers(-128, 128, (M, K)).astype(np.int8)).to(dev)
            w = torch.from_numpy(rng.integers(-128, 128, (K, N)).astype(np.int8)).to(dev)
            exact = (x.to(torch.float64) @ w.to(torch.float64)).to(torch.int32)
            got = int8_matmul(x, w)
            assert torch.equal(got, exact), (rep, M, K, N, (got != exact).nonzero().tolist()[:40])


def test_qat_forward_after_a_dropped_graph(dev):
    """The sequence of the one named mismatch, 20 times: a CUDA graph
    captured, replayed and dropped (``test_graph_keeps_its_engine_alive``),
    then the card-against-CPU QAT forwards at sm16 with the row-max GELU,
    whose message names the first module that differs and which side's
    product misses the exact one (``ROADMAP.md`` §3)."""
    for _ in range(20):
        test_graph_keeps_its_engine_alive(dev)
        test_qat_train_forward_on_card_matches_cpu(dev, 16, False)


# the trainer's entry points at a tiny size: (the model's flags, the
# launches a forward of its captured engine)
TRAINER_CLI_MODELS = {"deit_tiny": ([], {"K1": 12, "K3": 25}),
                      "swin_tiny": (["--window-size", "2"], {"K7": 12, "K3": 28})}


@pytest.mark.parametrize("model", sorted(TRAINER_CLI_MODELS))
def test_trainer_entry_points_on_the_card(dev, tmp_path, capsys, model):
    """``quant_train`` (one step), ``convert_model --checkpoint`` and
    ``evaluate_accuracy`` (one batch, the captured K1 + K3 or K7 + K3
    engine) with their default device, at a tiny size: the engine's
    logits against the SIM model's within 4 head output scales, argmax
    equal (for Swin on every row whose top two SIM logits lie more than
    8 head scales apart); the kernels on the trained artifact's own
    inputs against their plain versions."""
    from ivit_tpu_torch import convert_model, evaluate_accuracy, quant_train

    flags, per_forward = TRAINER_CLI_MODELS[model]
    data = ["--model", model, "--data-set", "SYNTHETIC", "--input-size", "32", "--nb-classes", "10"]
    train = data + flags + ["--batch-size", "16", "--aa", "none", "--color-jitter", "0", "--num-workers", "2",
                            "--output-dir", str(tmp_path)]
    quant_train.main(train + ["--epochs", "1", "--max-steps-per-epoch", "1", "--best-acc1", "-1"])
    ckpt, art = str(tmp_path / "checkpoint.pkl"), str(tmp_path / "artifact.pkl")
    assert (tmp_path / "best.pkl").exists()
    quant_train.main(train + ["--eval", "--resume", ckpt, "--dump-logits", str(tmp_path / "sim.npz")])
    convert_model.main(["--checkpoint", ckpt, "--output", art])
    capsys.readouterr()
    _, _, seen = evaluate_accuracy.main(data + ["--artifact", art, "--batch-size", "32", "--max-batches", "1",
                                                "--num-workers", "2", "--dump-logits", str(tmp_path / "eng.npz")])

    captured = re.search(r"launches a forward (\{.*\})", capsys.readouterr().out)
    assert seen == 32 and captured is not None and ast.literal_eval(captured.group(1)) == per_forward
    sim, eng = np.load(tmp_path / "sim.npz"), np.load(tmp_path / "eng.npz")
    np.testing.assert_array_equal(sim["labels"][:32], eng["labels"])
    with open(art, "rb") as f:
        artifact = pickle.load(f)
    head = float(np.max(artifact["head"]["out_scale"]))
    assert np.abs(sim["logits"][:32] - eng["logits"]).max() <= 4 * head
    top2 = np.sort(sim["logits"][:32], -1)[:, -2:]
    rows = (top2[:, 1] - top2[:, 0]) > 8 * head if model == "swin_tiny" else slice(None)
    np.testing.assert_array_equal(sim["logits"][:32].argmax(-1)[rows], eng["logits"].argmax(-1)[rows])
    from ivit_tpu_torch.data import SyntheticDataset
    from ivit_tpu_torch.data.transforms import EvalTransform

    images = np.stack([EvalTransform(32)(SyntheticDataset(32, 32).load(i)[0]) for i in range(32)])
    _kernels_on_artifact(artifact, torch.from_numpy(images).to(dev), dev)


def test_trainer_resume_on_the_card(dev, tmp_path, monkeypatch):
    """``quant_train`` at DeiT-S (224², batch 64, 4 steps an epoch, the
    CLI's defaults: sm16, the row-max GELU, mixup/cutmix) for two epochs,
    killed before the first step of epoch 1 (after epoch 0 wrote
    ``checkpoint.pkl`` and ``best.pkl``) and resumed, beside two
    uninterrupted runs: the resumed run's epoch-1 losses and parameters
    no further from the first uninterrupted run than the two
    uninterrupted runs are from each other (the card's sums may take
    another order from run to run). The first uninterrupted run's
    checkpoint then served (``_served_checkpoint``)."""
    from ivit_tpu_torch import quant_train, train
    from ivit_tpu_torch.nn.flax_state import flatten
    from ivit_tpu_torch.utils import load_checkpoint_raw

    steps = 4
    argv = [*CLI_TRAIN, "--model", "deit_small", "--batch-size", "64", "--max-steps-per-epoch", str(steps),
            "--epochs", "2"]

    class Killed(Exception):
        pass

    real = train.make_train_step

    def killed_before_step(*args, **kwargs):
        step, calls = real(*args, **kwargs), []

        def guarded(*step_args):
            if len(calls) == steps:
                raise Killed
            calls.append(None)
            return step(*step_args)

        return guarded

    with monkeypatch.context() as m, pytest.raises(Killed):
        m.setattr(train, "make_train_step", killed_before_step)
        quant_train.main(argv + ["--output-dir", str(tmp_path / "split")])
    assert (tmp_path / "split" / "checkpoint.pkl").exists() and (tmp_path / "split" / "best.pkl").exists()
    quant_train.main(argv + ["--output-dir", str(tmp_path / "split"), "--resume",
                             str(tmp_path / "split" / "checkpoint.pkl")])
    for name in ("whole1", "whole2"):
        quant_train.main(argv + ["--output-dir", str(tmp_path / name)])
    losses, params = {}, {}
    for name in ("split", "whole1", "whole2"):
        losses[name] = _epoch_losses(tmp_path / name, 1)
        params[name] = flatten(load_checkpoint_raw(str(tmp_path / name / "checkpoint.pkl"))[0]["params"])

    def gaps(a, b):
        return (max(abs(x - y) for x, y in zip(losses[a], losses[b])),
                max(float(np.abs(params[a][k] - params[b][k]).max()) for k in params[b]))

    assert len(losses["split"]) == len(losses["whole1"]) == steps
    resume_gap, runs_gap = gaps("split", "whole1"), gaps("whole1", "whole2")
    assert resume_gap[0] <= runs_gap[0] and resume_gap[1] <= runs_gap[1], (resume_gap, runs_gap)
    del params
    _served_checkpoint(str(tmp_path / "whole1" / "checkpoint.pkl"), argv, str(tmp_path / "serve"), dev)


FLOAT_TINY = {"deit_tiny_fp32": dict(img_size=32, patch_size=8, num_classes=10, embed_dim=64, depth=2, num_heads=4),
              "swin_tiny_fp32": dict(img_size=32, patch_size=2, num_classes=10, embed_dim=16, depths=(2, 2),
                                     num_heads=(2, 4), window_size=4)}


@pytest.mark.parametrize("name", sorted(FLOAT_TINY))
def test_float_model_on_card_matches_cpu(dev, name):
    """A float model on the card, TF32 off, against the CPU from the same
    seed: within 1e-5 (rtol = atol) of the CPU's logits (float32 sums in
    other orders, and the card's own ``erf``, ``exp`` and ``rsqrt``)."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((4, 32, 32, 3)).astype(np.float32))
    assert not torch.backends.cuda.matmul.allow_tf32
    with torch.no_grad():
        card = create_model(name, dev, seed=3, **FLOAT_TINY[name])(x.to(dev)).cpu()
        host = create_model(name, "cpu", seed=3, **FLOAT_TINY[name])(x)
    torch.testing.assert_close(card, host, rtol=1e-5, atol=1e-5)


def _seeded_state_dict(name, gen, grid=0, window=7):
    """A float checkpoint's state dict in the published layout of registered
    model ``name`` at 224² (DeiT/ViT: timm's; Swin: the official
    release's, with its ``relative_position_index`` and ``attn_mask``
    buffers), drawn from the torch generator ``gen``: LayerNorm weights
    1 + N(0, 0.1²), every other parameter N(0, 0.02²); a ViT's position
    embedding on a ``grid`` x ``grid`` patch grid."""
    from ivit_tpu_torch.models import create_config
    from ivit_tpu_torch.models.swin import relative_position_index, stage_geometry

    swin = name.startswith("swin")
    cfg = create_config(name, img_size=224, **({"window_size": window} if swin else {}))
    D, p = cfg["embed_dim"], cfg["patch_size"]
    shapes = {"patch_embed.proj.weight": (D, 3, p, p), "patch_embed.proj.bias": (D,)}
    buffers = {}

    def norm(prefix, n):
        shapes[f"{prefix}.weight"], shapes[f"{prefix}.bias"] = (n,), (n,)

    def linear(prefix, n_in, n_out, bias=True):
        shapes[f"{prefix}.weight"] = (n_out, n_in)
        if bias:
            shapes[f"{prefix}.bias"] = (n_out,)

    def block(prefix, dim):
        hidden = int(dim * cfg["mlp_ratio"])
        norm(f"{prefix}.norm1", dim)
        linear(f"{prefix}.attn.qkv", dim, 3 * dim)
        linear(f"{prefix}.attn.proj", dim, dim)
        norm(f"{prefix}.norm2", dim)
        linear(f"{prefix}.mlp.fc1", dim, hidden)
        linear(f"{prefix}.mlp.fc2", hidden, dim)

    if swin:
        norm("patch_embed.norm", D)
        for i, depth in enumerate(cfg["depths"]):
            dim = D * 2**i
            for j in range(depth):
                pre = f"layers.{i}.blocks.{j}"
                res, ws, shift = stage_geometry(cfg, i, j)
                block(pre, dim)
                shapes[f"{pre}.attn.relative_position_bias_table"] = ((2 * ws - 1) ** 2, cfg["num_heads"][i])
                buffers[f"{pre}.attn.relative_position_index"] = torch.from_numpy(
                    relative_position_index(ws).astype(np.int64))
                if shift:
                    buffers[f"{pre}.attn_mask"] = torch.from_numpy(sw_attn_mask(res, res, ws, shift))
            if i < len(cfg["depths"]) - 1:
                norm(f"layers.{i}.downsample.norm", 4 * dim)
                linear(f"layers.{i}.downsample.reduction", 4 * dim, 2 * dim, bias=False)
        nf = D * 2 ** (len(cfg["depths"]) - 1)
    else:
        shapes["cls_token"], shapes["pos_embed"] = (1, 1, D), (1, grid * grid + 1, D)
        for i in range(cfg["depth"]):
            block(f"blocks.{i}", D)
        nf = D
    norm("norm", nf)
    linear("head", nf, cfg["num_classes"])
    sd = {}
    for key, shape in shapes.items():
        t = torch.randn(shape, generator=gen)
        sd[key] = 1 + 0.1 * t if len(shape) == 1 and key.endswith(".weight") else 0.02 * t
    return {**sd, **buffers}


def _leaves_equal(got, want):
    """Every leaf of the nested ``want`` in ``got`` under the same path, bit
    for bit, and no other."""
    from ivit_tpu_torch.nn.flax_state import flatten

    got, want = flatten(got), flatten(want)
    assert got.keys() == want.keys(), sorted(set(got) ^ set(want))[:6]
    bad = [k for k in want if not np.array_equal(got[k], want[k])]
    assert not bad, bad[:6]


@pytest.mark.parametrize("source", ["deit_small", "swin_tiny", "vit_base_npz"])
def test_pretrained_import_on_card_equals_the_cpu(dev, source):
    """Seeded float checkpoints in the published layouts imported on the
    card by ``load_pretrained``, TF32 off: DeiT-S's ``.pth`` (``{"model":
    sd}``, its position embedding on a 24 x 24 grid, 577 tokens) and
    Swin-T's (with the release's ``relative_position_index`` and
    ``attn_mask`` buffers) into the QAT model, ViT-B's augreg ``.npz``
    into ``vit_base``: every parameter leaf equal to the importer's tree
    on the CPU, the 577 -> 197 resize among them, and that resize within
    float32 rounding of ``F.interpolate``'s bicubic on the card. On the
    same weights the float model (by ``quant_params_to_float`` ->
    ``merge_params`` -> ``load_flax_variables``) at batch 128 within 1e-5
    (rtol = atol) of the CPU's logits, and the SIM model calibrated on two
    batches of 64 correlated above 0.95 with it; for DeiT-S one
    ``SIM_FAST_MATMUL`` train-mode step at batch 64 against the float32
    step: logits and loss bit-equal, every gradient within 2^-5 of its
    leaf's largest entry."""
    from ivit_tpu_torch.models.import_swin import torch_swin_to_params
    from ivit_tpu_torch.models.import_torch import (
        load_pretrained,
        merge_params,
        npz_vit_to_params,
        resize_pos_embed,
        torch_vit_to_params,
    )
    from ivit_tpu_torch.models.swin_float import swin_quant_params_to_float
    from ivit_tpu_torch.models.vit_float import quant_params_to_float
    from ivit_tpu_torch.nn import flax_variables, load_flax_variables, quant

    assert not torch.backends.cuda.matmul.allow_tf32 and torch.get_float32_matmul_precision() == "highest"
    with tempfile.TemporaryDirectory() as tmp:
        if source == "vit_base_npz":
            sd = _seeded_state_dict("vit_base", torch.Generator().manual_seed(0), grid=14)
            arrays = augreg_npz({k: v.numpy() for k, v in sd.items()}, heads=12)
            path = os.path.join(tmp, "vit_base.npz")
            np.savez(path, **arrays)
            model = create_model("vit_base", dev, seed=0, img_size=224)
            load_pretrained(path, "vit_base", model)
            _leaves_equal(flax_variables(model)["params"], npz_vit_to_params(arrays, model.config["depth"]))
            return
        swin = source == "swin_tiny"
        geometry = {"window_size": 7} if swin else {}
        sd = _seeded_state_dict(source, torch.Generator().manual_seed(0), grid=0 if swin else 24)
        path = os.path.join(tmp, f"{source}.pth")
        torch.save({"model": sd}, path)
        qat = create_model(source, dev, seed=0, drop_path_rate=0.0, img_size=224, **geometry)
        load_pretrained(path, source, qat)
    want = (torch_swin_to_params if swin else torch_vit_to_params)(sd)
    if not swin:
        ntok = qat.pos_embed.shape[1]
        want["pos_embed"] = resize_pos_embed(want["pos_embed"], ntok)
    imported = flax_variables(qat)["params"]
    _leaves_equal(imported, want)
    if not swin:
        grid = round((ntok - 1) ** 0.5)
        g = sd["pos_embed"][:, 1:].reshape(1, 24, 24, -1).permute(0, 3, 1, 2).to(dev)
        ref = torch.nn.functional.interpolate(g, size=(grid, grid), mode="bicubic", align_corners=False)
        ref = ref.permute(0, 2, 3, 1).reshape(1, -1, g.shape[1]).cpu()
        assert float((qat.pos_embed[:, 1:].detach().cpu() - ref).abs().max()) <= 4e-6 + 1e-5 * float(ref.abs().max())

    images = torch.from_numpy(np.random.default_rng(0).standard_normal((128, 224, 224, 3), dtype=np.float32)).to(dev)
    fm = create_model(f"{source}_fp32", dev, seed=0, img_size=224, **geometry)
    rekeyed = (swin_quant_params_to_float if swin else quant_params_to_float)(imported)
    load_flax_variables(fm, {"params": merge_params(flax_variables(fm)["params"], rekeyed)})
    _leaves_equal(flax_variables(fm)["params"], rekeyed)
    with torch.no_grad():
        f_logits = fm(images)
        f_cpu = copy.deepcopy(fm).cpu()(images[:2].cpu())
    assert bool(torch.isfinite(f_logits).all())
    torch.testing.assert_close(f_logits[:2].cpu(), f_cpu, rtol=1e-5, atol=1e-5)
    with torch.no_grad():
        for i in range(2):
            qat(images[i * 64:(i + 1) * 64], train=True)
        s_logits = qat(images)
    assert np.corrcoef(f_logits.cpu().numpy().ravel(), s_logits.cpu().numpy().ravel())[0, 1] > 0.95
    if swin:
        return
    x = images[:64]
    classes = qat.config["num_classes"]
    targets = torch.full((64, classes), 0.1 / classes, device=dev)
    targets[torch.arange(64), torch.arange(64) % classes] += 0.9
    runs = {}
    try:
        for fast in (False, True):
            quant.SIM_FAST_MATMUL = fast
            m = copy.deepcopy(qat)
            logits = m(x, train=True)
            loss = soft_target_cross_entropy(logits, targets)
            runs[fast] = logits.detach(), loss.detach(), torch.autograd.grad(loss, list(m.parameters()),
                                                                             materialize_grads=True)
    finally:
        quant.SIM_FAST_MATMUL = False
    assert torch.equal(runs[True][0], runs[False][0]) and torch.equal(runs[True][1], runs[False][1])
    for (name, _), a, b in zip(qat.named_parameters(), runs[True][2], runs[False][2]):
        assert float((a - b).abs().max()) <= 2.0**-5 * max(float(b.abs().max()), 1e-30), name


# the trainer's entry points at 224² on the synthetic set, with the
# Pillow-free flags; --best-acc1 -1 makes the first validation a new best
CLI_DATA = ["--data-set", "SYNTHETIC", "--input-size", "224", "--nb-classes", "1000"]
CLI_TRAIN = CLI_DATA + ["--aa", "none", "--color-jitter", "0", "--best-acc1", "-1", "--print-freq", "1"]


def _epoch_losses(run_dir, epoch):
    """The losses of ``epoch``'s steps, from the last such line of a
    ``quant_train`` log."""
    return ast.literal_eval(re.findall(rf"epoch {epoch} losses (\[.*\])", (run_dir / "log.log").read_text())[-1])


def _served_checkpoint(ckpt, train_args, out_dir, dev, python_m=False):
    """A trainer checkpoint to its served engine: ``quant_train --eval
    --resume --dump-logits`` (the SIM logits) and ``convert_model
    --checkpoint`` (every flag from the record) in process, then
    ``evaluate_accuracy --dump-logits`` at batch 128 on the captured
    engine, a forward launching K1 + K3 (a ViT) or K7 + K3 (a Swin):
    counted in process through the capture's FORWARDS forwards or, with
    ``python_m``, read from the last lines of ``python -m
    ivit_tpu_torch.evaluate_accuracy --max-batches 1``. The engine's
    logits within 4 head output scales of SIM's, the same labels, the
    argmax equal on every row whose top two SIM logits lie more than 8
    head scales apart; then the kernels on the artifact's own inputs
    (``_kernels_on_artifact``)."""
    from ivit_tpu_torch import convert_model, evaluate_accuracy, quant_train
    from ivit_tpu_torch.data import SyntheticDataset
    from ivit_tpu_torch.data.transforms import EvalTransform
    from ivit_tpu_torch.deploy.graphs import FORWARDS
    from ivit_tpu_torch.utils import load_artifact

    os.makedirs(out_dir, exist_ok=True)
    sim_path, art_path, eng_path = (os.path.join(out_dir, f) for f in ("sim.npz", "artifact.pkl", "eng.npz"))
    quant_train.main([*train_args, "--eval", "--resume", ckpt, "--dump-logits", sim_path, "--output-dir", out_dir])
    convert_model.main(["--checkpoint", ckpt, "--output", art_path])
    gc.collect()
    torch.cuda.empty_cache()
    art = load_artifact(art_path)
    cfg = art["config"]
    if "depths" in cfg:
        blocks = sum(cfg["depths"])
        per_forward = {"K7": blocks, "K3": 2 * blocks + len(cfg["depths"])}
    else:
        per_forward = {"K1": cfg["depth"], "K3": 2 * cfg["depth"] + 1}
    model = train_args[train_args.index("--model") + 1]
    args = ["--model", model, "--artifact", art_path, *CLI_DATA, "--batch-size", "128", "--dump-logits", eng_path]
    if python_m:
        out = _python_m("ivit_tpu_torch.evaluate_accuracy", *args, "--max-batches", "1")
        captured = re.search(r"launches a forward (\{.*\})", out)
        assert captured is not None and ast.literal_eval(captured.group(1)) == per_forward, out[-2000:]
    else:
        _, counts = count_launches(evaluate_accuracy.main, args)
        assert counts == {k: FORWARDS * n for k, n in per_forward.items()}
    sim, eng = np.load(sim_path), np.load(eng_path)
    n = len(eng["labels"])
    np.testing.assert_array_equal(sim["labels"][:n], eng["labels"])
    s, e = sim["logits"][:n], eng["logits"]
    head = float(np.max(art["head"]["out_scale"]))
    assert float(np.abs(e - s).max()) <= 4 * head
    top2 = np.sort(s, -1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > 8 * head
    np.testing.assert_array_equal(s.argmax(-1)[clear], e.argmax(-1)[clear])
    images = np.stack([EvalTransform(224)(SyntheticDataset(128, 224).load(i)[0]) for i in range(128)])
    _kernels_on_artifact(art, torch.from_numpy(images).to(dev), dev)


@pytest.mark.parametrize("name", ["deit_small", "deit_small_fp32", "swin_tiny"])
def test_quant_train_from_a_pretrained_checkpoint_on_the_card(dev, tmp_path, name):
    """``quant_train --pretrained`` on the card from a seeded float
    checkpoint in the published layout (DeiT-S's ``.pth`` with its
    577-token position embedding, Swin-T's with the release's buffers) with
    ``--calib-batches 2``, two steps (DeiT-S at batch 64, Swin-T at 32):
    both losses finite, then the result served (``_served_checkpoint``).
    Swin-T's run and its ``evaluate_accuracy`` are launched by ``python
    -m`` as a user launches them, DeiT-S's in process.
    ``deit_small_fp32``: the float model through ``quant_train``, two
    steps at batch 64, both losses finite."""
    from ivit_tpu_torch import quant_train

    swin, pretrained = name == "swin_tiny", not name.endswith("_fp32")
    args = [*CLI_TRAIN, "--model", name, "--batch-size", "32" if swin else "64", "--max-steps-per-epoch", "2",
            "--epochs", "1", *(["--window-size", "7"] if swin else [])]
    extra = []
    if pretrained:
        sd = _seeded_state_dict(name, torch.Generator().manual_seed(0), grid=0 if swin else 24)
        torch.save({"model": sd}, tmp_path / f"{name}.pth")
        extra = ["--pretrained", str(tmp_path / f"{name}.pth"), "--calib-batches", "2"]
    if swin:
        _python_m("ivit_tpu_torch.quant_train", *args, *extra, "--output-dir", str(tmp_path / "run"))
    else:
        quant_train.main([*args, *extra, "--output-dir", str(tmp_path / "run")])
    losses = _epoch_losses(tmp_path / "run", 0)
    assert len(losses) == 2 and all(math.isfinite(v) for v in losses), losses
    if pretrained:
        gc.collect()
        torch.cuda.empty_cache()
        _served_checkpoint(str(tmp_path / "run" / "checkpoint.pkl"), args, str(tmp_path / "serve"), dev,
                           python_m=swin)


def test_fast_matmul_backward_on_card(dev, monkeypatch):
    """``SIM_FAST_MATMUL`` on the card: the backward of the exact dots is a
    bf16 GEMM with a float32 result, within float32 summation order
    (2·(K−1)·2^-24·Σ|aᵢ·bᵢ|) of the CPU's bf16-rounded float32 product,
    the forward unchanged, and cuBLAS's reduced-precision bf16 reduction
    setting as it was."""
    from ivit_tpu_torch.nn import exact_int8_dot_bias, exact_int_matmul, quant

    monkeypatch.setattr(quant, "SIM_FAST_MATMUL", True)
    rng = np.random.default_rng(7)
    cases = [(lambda a, b: exact_int8_dot_bias(a, b, torch.zeros(b.shape[1], device=a.device)),
              rng.integers(-128, 128, (3, 50, 384)), rng.integers(-128, 128, (384, 1536)), (3, 50, 1536)),
             (exact_int_matmul, rng.integers(-2**15, 2**15, (2, 6, 197, 197)), rng.integers(-128, 128, (2, 6, 197, 64)),
              (2, 6, 197, 64))]
    reduced = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    for fn, a, b, out_shape in cases:
        a, b = torch.from_numpy(a.astype(np.float32)), torch.from_numpy(b.astype(np.float32))
        g = torch.from_numpy(rng.standard_normal(out_shape).astype(np.float32))
        grads = {}
        for where in ("cpu", dev):
            at, bt = a.to(where).requires_grad_(), b.to(where).requires_grad_()
            y = fn(at, bt)
            grads[str(where)] = (y.detach().cpu(), *(t.cpu() for t in torch.autograd.grad(y, (at, bt), g.to(where))))
        card, host = grads[str(dev)], grads["cpu"]
        assert torch.equal(card[0], host[0])
        for i, (lhs, rhs) in ((1, (g, b.transpose(-1, -2))), (2, (a.transpose(-1, -2), g))):
            if i == 2 and b.dim() == 2:
                lhs, rhs = a.reshape(-1, a.shape[-1]).T, g.reshape(-1, g.shape[-1])
            lhs16, rhs16 = (t.to(torch.bfloat16).to(torch.float64) for t in (lhs, rhs))
            k = lhs.shape[-1]
            bound = 2 * (k - 1) * 2.0**-24 * torch.matmul(lhs16.abs(), rhs16.abs())
            assert bool(((card[i].to(torch.float64) - host[i].to(torch.float64)).abs() <= bound.reshape(card[i].shape)).all())
    assert torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction == reduced


@pytest.mark.parametrize(
    "kernels,counts,stable",
    [
        (("attention", "layernorm"), {"K1": 2, "K3": 5}, False),
        (("layernorm", "attention2", "linear_gelu"), {"K2": 2, "K4": 2, "K3": 5}, False),
        (("layernorm", "softmax", "gelu"), {"K6": 2, "K5": 2, "K3": 5}, False),
        (("attention", "layernorm"), {"K1": 2, "K3": 5, "K9": 2}, True),
    ],
    ids=["main", "A", "B", "main_stable"],
)
def test_exported_engine_on_card_equals_live(dev, kernels, counts, stable):
    """An engine exported on the card and reloaded from its bytes: the
    live engine's logits (tolerance 0) and its launches, counted by the
    operators; captured as a CUDA graph, the same again. ``main_stable``
    is the benchmark's path: sm8 and the stable GELU, K9 in each block."""
    artifact = synthetic_vit_artifact(
        "deit_tiny", seed=1, softmax_bits=8 if stable else 16, gelu_stable=stable,
        img_size=32, patch_size=8, embed_dim=128, depth=2, num_heads=2, num_classes=16,
    )
    images = torch.from_numpy(np.random.default_rng(2).standard_normal((3, 32, 32, 3)).astype(np.float32)).to(dev)
    live = build_vit_infer(artifact, dev, kernels=kernels)
    engine = load_engine(export_engine(live, 3, 32))
    logits, launched = count_launches(engine, images)
    assert launched == counts
    torch.testing.assert_close(logits, live(images), rtol=0, atol=0)
    replay = capture_infer(engine, 3, 32, dev)
    assert replay.launches == counts
    torch.testing.assert_close(replay(images), logits, rtol=0, atol=0)


def test_exported_engines_reload_in_a_fresh_process(dev, tmp_path):
    """The published paths' engines (DeiT-S main, sm16 routes A and B,
    strict mode on the main path's artifact, Swin-T) exported on the card
    at batch 128 and 1, a path a rank on five ranks at once
    (``export_engines``), then all reloaded in one fresh process that
    builds no engine (``scripts/torch_reload_engine.py``, which exits 0):
    each file's logits equal to the live engine's (tolerance 0) and its
    launches a forward, counted there by the operators (none in strict
    mode). Each but strict mode's file also reloaded in this process,
    eager and captured as a CUDA graph: equal to the live engine, its
    captured launches a forward."""
    from torch_parallel_worker import export_engines, run_ranks

    x = _published_images(128).to(dev)
    np.save(tmp_path / "images.npy", x.cpu().numpy())
    paths, groups = {}, []
    for name, key in (("main", "deit_s"), ("A", "deit_s16_A"), ("B", "deit_s16_B"), ("swin", "swin_t")):
        artifact, infer, _ = _published(key, dev)
        kernels, per_forward = PUBLISHED_PATHS[key][2:4]
        paths[name] = (infer, per_forward)
        groups.append((name, artifact, {} if kernels is None else {"kernels": kernels}))
        if name == "main":
            strict = dict(kernels=(), strict_dyadic=True)
            paths["strict"] = (build_vit_infer(artifact, dev, **strict), {})
            groups.append(("strict", artifact, strict))
    files = {(name, b): str(tmp_path / f"{name}_b{b}.pt2") for name in paths for b in (128, 1)}
    run_ranks(len(groups), tmp_path / "export", export_engines,
              [(a, o, [(b, files[name, b]) for b in (128, 1)]) for name, a, o in groups], backend="gloo",
              device="cuda")
    live = {name: infer(x).cpu() for name, (infer, _) in paths.items()}
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    run = subprocess.run([sys.executable, os.path.join(repo, "scripts", "torch_reload_engine.py"),
                          str(tmp_path / "images.npy"), *files.values()],
                         cwd=repo, capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-4000:]
    by_file = {line["engine"]: line for line in map(json.loads, run.stdout.strip().splitlines())}
    assert len(by_file) == len(files)
    for (name, b), path in files.items():
        assert by_file[path]["launches"] == paths[name][1], path
        torch.testing.assert_close(torch.from_numpy(np.load(path + ".logits.npy")), live[name][:b], rtol=0, atol=0)
        if name != "strict":
            engine = load_engine(path)
            torch.testing.assert_close(engine(x[:b]).cpu(), live[name][:b], rtol=0, atol=0)
            replay = capture_infer(engine, b, 224, dev)
            assert replay.launches == paths[name][1], path
            torch.testing.assert_close(replay(x[:b]).cpu(), live[name][:b], rtol=0, atol=0)
            del engine, replay
            torch.cuda.empty_cache()


@pytest.mark.parametrize("seeded", [True, False], ids=["generator", "global-rng"])
@pytest.mark.parametrize("name", ["deit_tiny", "swin_tiny", "vit_large", "swin_base"])
def test_remat_step_on_card_equals_no_remat(dev, name, seeded):
    """One train step with drop-path 0.1 on the card, the masks drawn from
    a seeded generator or from the card's global one, with and without
    ``remat``: logits and every range bit-equal, gradients within 1e-5 of
    each leaf's largest entry (the backward's sums may take another order
    on the card), the generator's state equal. Tiny models at 32², and
    ViT-L and Swin-B at their published widths and depths at 224²."""
    small = {"deit_tiny": dict(img_size=32, num_classes=16, depth=2),
             "swin_tiny": dict(img_size=32, num_classes=16, depths=(2, 2), num_heads=(2, 4), window_size=4,
                               embed_dim=32)}.get(name, {})
    size, classes = small.get("img_size", 224), small.get("num_classes", 1000)
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((4, size, size, 3)).astype(np.float32)).to(dev)
    t = torch.full((4, classes), 1 / classes, device=dev)
    runs = []
    for remat in (False, True):
        model = create_model(name, dev, seed=2, drop_path_rate=0.1, remat=remat, **small)
        gen = torch.Generator(device=dev).manual_seed(9) if seeded else None
        torch.cuda.manual_seed(9)
        names, params = zip(*model.named_parameters())
        logits = model(x, train=True, generator=gen)
        grads = torch.autograd.grad(soft_target_cross_entropy(logits, t), params, materialize_grads=True)
        state = gen.get_state() if seeded else torch.cuda.get_rng_state(dev)
        runs.append((logits.detach(), dict(model.named_buffers()), dict(zip(names, grads)), state))
    (l0, b0, g0, s0), (l1, b1, g1, s1) = runs
    torch.testing.assert_close(l1, l0, rtol=0, atol=0)
    for n in b0:
        torch.testing.assert_close(b1[n], b0[n], rtol=0, atol=0, msg=n)
    for n in g0:
        torch.testing.assert_close(g1[n], g0[n], rtol=0, atol=1e-5 * float(g0[n].abs().max()), msg=n)
    assert torch.equal(s0, s1)


def test_int_mm_on_a_dropped_graphs_stream_stays_exact(dev):
    """The suspect of the sporadic QAT-forward mismatch (``ROADMAP.md``
    §3): a cuBLAS(Lt) workspace handed out from a CUDA graph's private
    pool and reused after the graph is dropped. A graph is captured on a
    fresh side stream with no warm-up there (so whatever that stream's
    first GEMM allocates, it allocates in the graph's pool), replayed and
    dropped, the cache emptied and the freed memory refilled with noise;
    then the same GEMMs run on that stream and on the default stream,
    100 times each, exact against float64."""
    from ivit_tpu_torch.ops.intmm import int8_matmul

    rng = np.random.default_rng(11)
    shapes = ((16, 192, 32), (17, 192, 32), (16, 32, 128), (256, 384, 1152))
    operands = [(torch.from_numpy(rng.integers(-128, 128, (M, K)).astype(np.int8)).to(dev),
                 torch.from_numpy(rng.integers(-128, 128, (K, N)).astype(np.int8)).to(dev)) for M, K, N in shapes]
    exact = [(x.to(torch.float64) @ w.to(torch.float64)).to(torch.int32) for x, w in operands]
    stream = torch.cuda.Stream(dev)
    stream.wait_stream(torch.cuda.current_stream(dev))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        outs = [int8_matmul(x, w) for x, w in operands]
    graph.replay()
    torch.cuda.synchronize()
    for got, want in zip(outs, exact):
        assert torch.equal(got, want)
    del graph, outs
    gc.collect()
    torch.cuda.empty_cache()
    for rep in range(100):
        noise = [torch.randint(-128, 128, (int(n),), dtype=torch.int8, device=dev) for n in rng.integers(1, 1 << 22, 8)]
        for on in (stream, torch.cuda.current_stream(dev)):
            with torch.cuda.stream(on):
                got = [int8_matmul(x, w) for x, w in operands]
            on.synchronize()
            for (M, K, N), g, want in zip(shapes, got, exact):
                assert torch.equal(g, want), (rep, M, K, N, (g != want).nonzero().tolist()[:20])
        del noise


# ---- K10: the fused attention over rows of 257 to 1,024 tokens ------------------------------------


def _long_edge_case(N, hd=64):
    """int8 q, k, v of three cells whose every row's exp sum passes 2^24 at
    r1 = 1 and scale 1/3: all-equal rows (every score 100), and rows whose
    last (or first) 177 scores are 69 and the rest 100, a sum whose low
    bits float32 rounds away (``tests/test_torch_attention_long.py``)."""
    q = torch.ones((3, N, hd), dtype=torch.int8)
    k = torch.tensor([2] * 36 + [1] * 28, dtype=torch.int8)[:hd].repeat(3, N, 1)
    low = torch.tensor([2] * 5 + [1] * 59, dtype=torch.int8)[:hd]
    k[1, N - 177:] = low
    k[2, :177] = low
    v = torch.randint(-128, 128, (3, N, hd), generator=torch.Generator().manual_seed(N), dtype=torch.int8)
    return q, k, v


@pytest.mark.parametrize("N", [257, 290, 577, 1024])
@pytest.mark.parametrize("out_bits", [8, 16])
def test_long_attention_kernel_matches_reference(dev, N, out_bits):
    """K10 equals its plain version and K1's bit for bit: random cells at
    four ratio pairs, a tied and a saturated row, and the edge rows."""
    cases = [(_attention_case(12, N, 64, out_bits, seed=N)[0], ratios)
             for ratios in ((1 / 2000.0, 1 / 40.0, 1 / 300.0), (1 / 400.0, 1 / 8.0, 1 / 300.0),
                            (1 / 100.0, 1 / 300.0, 1 / 300.0), (1e-5, 1 / 600.0, 1 / 300.0))]
    cases.append((list(_long_edge_case(N)), (1.0, 1 / 3.0, 1 / 300.0)))
    for qkv, ratios in cases:
        out = _launched_once(fused_int8_attention_long, *(a.to(dev) for a in qkv), *ratios, out_bits)
        ref = fused_int8_attention_long_reference(*qkv, *ratios, out_bits)
        torch.testing.assert_close(out.cpu(), ref, rtol=0, atol=0)
        torch.testing.assert_close(ref, fused_int8_attention_reference(*qkv, *ratios, out_bits), rtol=0, atol=0)


def test_long_attention_kernel_at_vit_l384_batch_128(dev):
    """K10 at ViT-L/16 at 384², batch 128: (2048, 577, 64), against the
    plain version on the card, 256 cells at a time."""
    g = torch.Generator(device=dev).manual_seed(5)
    q, k, v = (torch.randint(-128, 128, (2048, 577, 64), generator=g, device=dev, dtype=torch.int8) for _ in range(3))
    ratios = (1 / 2000.0, 1 / 40.0, 1 / 300.0)
    out = fused_int8_attention_long(q, k, v, *ratios)
    for i in range(0, 2048, 256):
        ref = fused_int8_attention_long_reference(q[i:i + 256], k[i:i + 256], v[i:i + 256], *ratios)
        torch.testing.assert_close(out[i:i + 256], ref, rtol=0, atol=0)
