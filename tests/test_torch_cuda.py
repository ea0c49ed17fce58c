"""The port's CUDA kernels on the card: each bit-equal (tolerance 0) to its
plain torch version, and the engine's kernel path bit-equal to the CPU.

Every test here needs a CUDA device and skips without one (the kernels
have no CPU mode). The file imports no JAX, so it runs on a machine
without it; from the repository root:

    python -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest -p no:cacheprovider

(``--noconftest``: ``tests/conftest.py`` imports JAX.)
"""

import contextlib

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
    before = fused_int8_attention.launches
    out = fused_int8_attention(*(a.to(dev) for a in qkv), *ratios, out_bits)
    torch.cuda.synchronize()
    assert fused_int8_attention.launches == before + 1
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
    before = fused_layernorm_requant.launches
    out = fused_layernorm_requant(*(a.to(dev) for a in args))
    torch.cuda.synchronize()
    assert fused_layernorm_requant.launches == before + 1
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
    before = fused_layernorm_requant.launches
    out = fused_layernorm_requant(*args)
    torch.cuda.synchronize()
    assert fused_layernorm_requant.launches == before + 1
    return out, fused_layernorm_requant_reference(*args)


# every width the paths run (Swin-T's four stages and merges, DeiT-S), at
# a row count past one resident wave of blocks and not a multiple of the
# rows of a block, on edge rows, with 16-byte loads and, from a base 2
# bytes past a 16-byte boundary, with the scalar instantiation
@pytest.mark.parametrize("aligned", [True, False], ids=["vec", "unaligned"])
@pytest.mark.parametrize("C", [96, 192, 384, 768, 1536])
def test_layernorm_kernel_at_path_widths(dev, C, aligned):
    x, bias, ratio = _layernorm_edges(100003 if aligned else 20011, C, seed=C)
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


@pytest.mark.parametrize("softmax_bits,gelu_stable", [(8, True), (16, False)])
def test_engine_kernel_path_matches_cpu(dev, softmax_bits, gelu_stable):
    artifact = synthetic_vit_artifact(
        "deit_tiny", seed=1, softmax_bits=softmax_bits, gelu_stable=gelu_stable,
        img_size=32, patch_size=8, embed_dim=128, depth=2, num_heads=2, num_classes=16,
    )
    images = torch.from_numpy(np.random.default_rng(2).standard_normal((3, 32, 32, 3)).astype(np.float32))
    k1, k3, k9 = fused_int8_attention.launches, fused_layernorm_requant.launches, fused_requant_stable_gelu.launches
    logits = build_vit_infer(artifact, dev)(images)
    torch.cuda.synchronize()
    assert fused_int8_attention.launches - k1 == 2
    assert fused_layernorm_requant.launches - k3 == 5
    assert fused_requant_stable_gelu.launches - k9 == (2 if gelu_stable else 0)  # K9: depth, on stable models
    torch.testing.assert_close(logits.cpu(), build_vit_infer(artifact, "cpu")(images), rtol=0, atol=0)


@pytest.mark.parametrize("out_bits", [8, 16])
@pytest.mark.parametrize("shape", ATTENTION_SHAPES, ids=_attention_ids)
def test_attention_v2_kernel_matches_reference(dev, shape, out_bits):
    qkv, ratios = _attention_case(*shape, out_bits, seed=10 + out_bits)
    N = shape[1]
    before = fused_int8_attention_v2.launches
    out = fused_int8_attention_v2(*(a.to(dev) for a in qkv), *ratios, N, out_bits)
    torch.cuda.synchronize()
    assert fused_int8_attention_v2.launches == before + 1
    ref = fused_int8_attention_v2_reference(*qkv, *ratios, N, out_bits)
    torch.testing.assert_close(out.cpu(), ref, rtol=0, atol=0)
    # under K2's gate: K1's integers
    torch.testing.assert_close(ref, fused_int8_attention_reference(*qkv, *ratios, out_bits), rtol=0, atol=0)


@pytest.mark.parametrize("out_bits", [8, 16])
@pytest.mark.parametrize("N", [1, 17, 197])
def test_attention_kernels_at_edges(dev, N, out_bits):
    """A power-of-two 1/scale (one-token rows reach probability
    2^(out_bits-1): 128, 32768), rows of equal scores, and rows clipped at
    -128 and +127 against V = -128 (the largest |context|)."""
    qkv, (r1, scale, r_out) = _attention_case(4, N, 64, out_bits, seed=N, scale=0.125)
    q, k, v = qkv
    q[1], k[1] = 0, 5  # all scores 0: every column ties
    q[2], k[2], v[2] = 127, -128, -128  # every score clips at -128
    q[3], k[3], v[3] = 127, 127, -128  # every score clips at +127
    probs = attention_probabilities(q, k, r1, scale, out_bits)
    if N == 1:
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
    before = fused_requant_shiftgelu.launches
    out = fused_requant_shiftgelu(x.to(dev), r1.to(dev), *GELU_SCALES)
    torch.cuda.synchronize()
    assert fused_requant_shiftgelu.launches == before + 1
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
    before = fused_requant_shiftgelu.launches
    args = (x.to(dev), r1.to(dev), *GELU_SCALES)
    out = fused_requant_shiftgelu(*args)
    torch.cuda.synchronize()
    assert fused_requant_shiftgelu.launches == before + 1
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
    before = fused_linear_shiftgelu.launches
    out = fused_linear_shiftgelu(x.to(dev), w_t.to(dev).T, *(a.to(dev) for a in args[:2]), *GELU_SCALES)
    torch.cuda.synchronize()
    assert fused_linear_shiftgelu.launches == before + 1
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
    before = fused_linear_shiftgelu.launches
    out = fused_linear_shiftgelu(x.to(dev), w_t.to(dev).T, b.to(dev), r1.to(dev), *GELU_SCALES)
    torch.cuda.synchronize()
    assert fused_linear_shiftgelu.launches == before + 1
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


# DeiT-S fc1 at batch 128 and 1, a ragged M, widths that are not
# multiples of 128 words, a C that is not a multiple of 4 (one channel a
# thread), and the per-rank width at TP = 2
@pytest.mark.parametrize("shape", [(25216, 1536), (197, 1536), (1003, 1536), (37, 1540), (5, 99), (25216, 768)])
def test_stable_gelu_kernel_matches_reference(dev, shape):
    x, b, r1, table = _stable_gelu_case(*shape, seed=shape[0] + shape[1])
    args = [a.to(dev) for a in (x, b, r1, table)]
    before = fused_requant_stable_gelu.launches
    out = fused_requant_stable_gelu(*args)
    torch.cuda.synchronize()
    assert fused_requant_stable_gelu.launches == before + 1
    torch.testing.assert_close(out.cpu(), fused_requant_stable_gelu_reference(x, b, r1, table), rtol=0, atol=0)
    assert out.unique().numel() > (50 if shape[0] > 100 else 20)


def test_stable_gelu_kernel_off_16_byte_boundaries(dev):
    """x, b and r1 whose bases lie 4 bytes past a 16-byte boundary take
    the one-channel path; the result is the same."""
    x, b, r1, table = _stable_gelu_case(1000, 1536, seed=3)

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


# (M, N, n_valid): route B's batch-1 shape, N in (1, 5, 197, 256) with
# n_valid below and at N, and M not a multiple of the kernel's 16-row tile
SHIFTMAX_SHAPES = [(1182, 197, 197), (64, 256, 200), (7, 5, 5), (7, 5, 3), (7, 1, 1), (1182, 1, 1),
                   (7, 197, 99), (1182, 256, 256), (1182, 256, 1)]


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
    before = fused_requant_shiftmax.launches
    hi, lo = fused_requant_shiftmax(xd, r1, scale, n_valid, out_bits)
    torch.cuda.synchronize()
    assert fused_requant_shiftmax.launches == before + 1
    rhi, rlo = fused_requant_shiftmax_reference(x, r1, scale, n_valid, out_bits)
    torch.testing.assert_close(hi.cpu(), rhi, rtol=0, atol=0)
    torch.testing.assert_close(lo.cpu(), rlo, rtol=0, atol=0)
    if n_valid == 1 and scale == 0.125 and out_bits == 16:
        assert (rhi[:, 0] == 127).all()


@pytest.mark.parametrize(
    "kernels,counts",
    [
        (("layernorm", "attention2", "linear_gelu"), {"K2": 2, "K4": 2, "K3": 5}),
        (("layernorm", "softmax", "gelu"), {"K6": 2, "K5": 2, "K3": 5}),
    ],
    ids=["A", "B"],
)
def test_engine_sm16_routes_match_cpu(dev, kernels, counts):
    artifact = synthetic_vit_artifact(
        "deit_tiny", seed=1, softmax_bits=16, gelu_stable=False,
        img_size=32, patch_size=8, embed_dim=128, depth=2, num_heads=2, num_classes=16,
    )
    images = torch.from_numpy(np.random.default_rng(2).standard_normal((3, 32, 32, 3)).astype(np.float32))
    infer = build_vit_infer(artifact, dev, kernels=kernels)
    for fn in WRAPPERS.values():
        fn.launches = 0
    logits = infer(images)
    torch.cuda.synchronize()
    assert {name: fn.launches for name, fn in WRAPPERS.items() if fn.launches} == counts
    cpu = build_vit_infer(artifact, "cpu", kernels=())(images)
    torch.testing.assert_close(logits.cpu(), cpu, rtol=0, atol=0)


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
    before = fused_int8_window_attention.launches
    out = fused_int8_window_attention(*(a.to(dev) for a in qkv), bias.to(dev), None if mask is None else mask.to(dev), *args)
    torch.cuda.synchronize()
    assert fused_int8_window_attention.launches == before + 1
    ref = fused_int8_window_attention_reference(*qkv, bias, mask, *args)
    torch.testing.assert_close(out.cpu(), ref, rtol=0, atol=0)
    assert ref.unique().numel() > 20


def test_swin_engine_kernel_path_matches_cpu(dev):
    artifact = synthetic_swin_artifact(
        "swin_tiny", seed=1, img_size=56, patch_size=4, embed_dim=32, depths=(2, 2), num_heads=(2, 4),
        num_classes=16,
    )  # stage 1: 14x14 tokens in 7x7 windows, block 1 shifted; stage 2: one window
    images = torch.from_numpy(np.random.default_rng(2).standard_normal((3, 56, 56, 3)).astype(np.float32))
    infer = build_swin_infer(artifact, dev)
    for fn in WRAPPERS.values():
        fn.launches = 0
    logits = infer(images)
    torch.cuda.synchronize()
    assert {name: fn.launches for name, fn in WRAPPERS.items() if fn.launches} == {"K7": 4, "K3": 10}
    cpu = build_swin_infer(artifact, "cpu", kernels=())(images)
    torch.testing.assert_close(logits.cpu(), cpu, rtol=0, atol=0)
    torch.testing.assert_close(build_swin_infer(artifact, dev, kernels=())(images).cpu(), cpu, rtol=0, atol=0)


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
    before = fused_int8_window_attention.launches
    out = fused_int8_window_attention(*args, r1, rb, scale, r_out, heads)
    torch.cuda.synchronize()
    assert fused_int8_window_attention.launches == before + 1
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
}


def _graph_engine(dev, path):
    model, bits, stable, kernels, counts = GRAPH_PATHS[path]
    if model == "swin":
        artifact = synthetic_swin_artifact(
            "swin_tiny", seed=1, img_size=56, patch_size=4, embed_dim=32, depths=(2, 2), num_heads=(2, 4),
            num_classes=16,
        )
        build, size = build_swin_infer, 56
    else:
        artifact = synthetic_vit_artifact(
            "deit_tiny", seed=1, softmax_bits=bits, gelu_stable=stable,
            img_size=32, patch_size=8, embed_dim=128, depth=2, num_heads=2, num_classes=16,
        )
        build, size = build_vit_infer, 32
    infer = build(artifact, dev) if kernels is None else build(artifact, dev, kernels=kernels)
    return infer, size, counts


@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("path", sorted(GRAPH_PATHS))
def test_graph_replay_is_bit_equal_to_eager(dev, path, batch):
    """The captured forward's logits equal the eager engine's (tolerance
    0); its launches, counted during the capture, are one forward's, and a
    replay launches nothing through a wrapper."""
    infer, size, counts = _graph_engine(dev, path)
    images = torch.from_numpy(np.random.default_rng(batch).standard_normal((batch, size, size, 3)).astype(np.float32))
    eager = infer(images.to(dev))
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


def test_forward_makes_no_host_synchronisation(dev):
    """After its first call a forward copies nothing from the host and
    never waits for the device (what a capture needs), on every path."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def syncs(fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
        return sorted(e.name for e in prof.events() if e.device_type == DeviceType.CPU
                      and e.name in ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaMemcpy"))

    empty = syncs(lambda: None)  # the profiler's own
    for path in sorted(GRAPH_PATHS):
        infer, size, _ = _graph_engine(dev, path)
        images = torch.from_numpy(np.random.default_rng(0).standard_normal((2, size, size, 3)).astype(np.float32)).to(dev)
        infer(images)
        assert syncs(lambda: infer(images)) == empty, path


@pytest.mark.parametrize("softmax_bits,gelu_stable", [(8, True), (16, False)])
def test_strict_engine_on_card_matches_cpu(dev, softmax_bits, gelu_stable):
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
    import gc

    infer, size, _ = _graph_engine(dev, "main")
    images = torch.from_numpy(np.random.default_rng(6).standard_normal((2, size, size, 3)).astype(np.float32)).to(dev)
    eager = infer(images)
    graphed = capture_infer(infer, 2, size, dev)
    del infer
    gc.collect()
    torch.cuda.empty_cache()
    torch.testing.assert_close(graphed(images), eager, rtol=0, atol=0)


# the QAT trainer on the card: the tiny model of tests/test_torch_qat_model.py
QAT_TINY = dict(img_size=16, patch_size=8, num_classes=8, embed_dim=32, depth=2, num_heads=4)
QAT_GRAD_RTOL = 1e-5  # of each leaf's largest entry: float32 sums in other orders
ROUTE_A = ("layernorm", "attention2", "linear_gelu")


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
    for w in WRAPPERS.values():
        w.launches = 0
    logits = infer(images.to(dev))
    torch.cuda.synchronize()
    depth = QAT_TINY["depth"]
    assert {k: w.launches for k, w in WRAPPERS.items() if w.launches} == {"K2": depth, "K4": depth, "K3": 2 * depth + 1}
    torch.testing.assert_close(logits.cpu(), build_vit_infer(art_cpu, "cpu", kernels=())(images), rtol=0, atol=0)



# the Swin QAT trainer on the card: full Swin-T for one step, config (b) of
# tests/test_torch_qat_swin.py (window 7 over a 14 x 14 grid, L = 49) for
# training, freezing and serving
QAT_SWIN_TINY = dict(img_size=28, patch_size=2, num_classes=8, embed_dim=16, depths=(2, 2), num_heads=(2, 4),
                     window_size=7)


def test_qat_swin_step_on_card_matches_cpu(dev):
    """One train-mode step of Swin-T at full width and depth, batch 2,
    drop-path 0, smoothed one-hot targets: logits, loss and every range
    bit-equal to the CPU; every parameter gradient within QAT_GRAD_RTOL
    of its leaf's largest entry; every bias table's gradient nonzero."""
    from ivit_tpu_torch.train.augment import one_hot_smooth

    card = create_model("swin_tiny", device=dev, drop_path_rate=0.0)
    cpu = create_model("swin_tiny", device="cpu", drop_path_rate=0.0)
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.standard_normal((2, 224, 224, 3)).astype(np.float32))
    t = one_hot_smooth(torch.from_numpy(rng.integers(0, 1000, 2)), 1000, 0.1)
    lc, lh = card(x.to(dev), train=True), cpu(x, train=True)
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


@pytest.mark.parametrize("use_cutmix", [False, True], ids=["mixup", "cutmix"])
def test_mixup_cutmix_on_card_matches_cpu(dev, use_cutmix):
    """The mixup/cutmix arithmetic on the card and on the CPU from the same
    draws: images and soft targets bit-equal, on each branch."""
    from ivit_tpu_torch.train import MixupConfig
    from ivit_tpu_torch.train.augment import apply_mixup, draw_mixup

    cfg = MixupConfig()
    rng = np.random.default_rng(9)
    images = torch.from_numpy(rng.standard_normal((16, 224, 224, 3)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 1000, 16))
    draws = draw_mixup(cfg, 224, 224, rng)._replace(use_cutmix=use_cutmix)
    (ic, tc), (ih, th) = apply_mixup(images.to(dev), labels.to(dev), cfg, draws), apply_mixup(images, labels, cfg, draws)
    torch.testing.assert_close(ic.cpu(), ih, rtol=0, atol=0)
    torch.testing.assert_close(tc.cpu(), th, rtol=0, atol=0)


def test_qat_swin_freeze_serves_on_card(dev):
    """A Swin trained on the card with mixup/cutmix targets, frozen there:
    the artifact equals the one frozen from the same variables on the
    CPU, and the default kernels (one K7 a block; two K3 a block, one a
    patch merging and the final norm) serve it bit-equal to the plain
    engine on the CPU."""
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
        step(state, *mixup_cutmix(x, y, MixupConfig(num_classes=8), rng, device=dev), gen)
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
    for w in WRAPPERS.values():
        w.launches = 0
    logits = infer(images.to(dev))
    torch.cuda.synchronize()
    blocks, stages = sum(QAT_SWIN_TINY["depths"]), len(QAT_SWIN_TINY["depths"])
    assert {k: w.launches for k, w in WRAPPERS.items() if w.launches} == {"K7": blocks, "K3": 2 * blocks + stages}
    torch.testing.assert_close(logits.cpu(), build_swin_infer(art_cpu, "cpu", kernels=())(images), rtol=0, atol=0)


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


def test_int8_matmul_exact_after_graph_capture_and_churn(dev):
    """The patch-embed GEMM of the tiny QAT model (16 x 192 @ 192 x 32,
    padded to 17 rows) and its neighbours exact against float64, 100
    times each, after an engine's CUDA graph was captured, replayed and
    dropped and the allocator's freed blocks were refilled with noise:
    the state of the process in which the one named mismatch of
    ``test_qat_train_forward_on_card_matches_cpu`` showed
    (``ROADMAP.md`` §3)."""
    import gc

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


def test_trainer_entry_points_on_the_card(dev, tmp_path, capsys):
    """``quant_train`` (one step), ``convert_model --checkpoint`` and
    ``evaluate_accuracy`` (one batch, the captured K1 + K3 engine) with
    their default device, at a tiny size: the engine's logits against the
    SIM model's within 4 head output scales, argmax equal."""
    import pickle

    from ivit_tpu_torch import convert_model, evaluate_accuracy, quant_train

    data = ["--model", "deit_tiny", "--data-set", "SYNTHETIC", "--input-size", "32", "--nb-classes", "10"]
    train = data + ["--batch-size", "16", "--aa", "none", "--color-jitter", "0", "--num-workers", "2",
                    "--output-dir", str(tmp_path)]
    quant_train.main(train + ["--epochs", "1", "--max-steps-per-epoch", "1", "--best-acc1", "-1"])
    ckpt, art = str(tmp_path / "checkpoint.pkl"), str(tmp_path / "artifact.pkl")
    assert (tmp_path / "best.pkl").exists()
    quant_train.main(train + ["--eval", "--resume", ckpt, "--dump-logits", str(tmp_path / "sim.npz")])
    convert_model.main(["--checkpoint", ckpt, "--output", art])
    capsys.readouterr()
    _, _, seen = evaluate_accuracy.main(data + ["--artifact", art, "--batch-size", "32", "--max-batches", "1",
                                                "--num-workers", "2", "--dump-logits", str(tmp_path / "eng.npz")])
    out = capsys.readouterr().out
    assert seen == 32 and "launches a forward {'K1': 12, 'K3': 25}" in out
    sim, eng = np.load(tmp_path / "sim.npz"), np.load(tmp_path / "eng.npz")
    np.testing.assert_array_equal(sim["labels"][:32], eng["labels"])
    with open(art, "rb") as f:
        head = float(np.max(pickle.load(f)["head"]["out_scale"]))
    assert np.abs(sim["logits"][:32] - eng["logits"]).max() <= 4 * head
    np.testing.assert_array_equal(sim["logits"][:32].argmax(-1), eng["logits"].argmax(-1))


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
    for fn in WRAPPERS.values():
        fn.launches = 0
    logits = engine(images)
    torch.cuda.synchronize()
    assert {name: fn.launches for name, fn in WRAPPERS.items() if fn.launches} == counts
    torch.testing.assert_close(logits, live(images), rtol=0, atol=0)
    replay = capture_infer(engine, 3, 32, dev)
    assert replay.launches == counts
    torch.testing.assert_close(replay(images), logits, rtol=0, atol=0)


@pytest.mark.parametrize("seeded", [True, False], ids=["generator", "global-rng"])
@pytest.mark.parametrize("name", ["deit_tiny", "swin_tiny"])
def test_remat_step_on_card_equals_no_remat(dev, name, seeded):
    """One train step with drop-path 0.1 on the card, the masks drawn from
    a seeded generator or from the card's global one, with and without
    ``remat``: logits and every range bit-equal, gradients within 1e-5 of
    each leaf's largest entry (the backward's sums may take another order
    on the card), the generator's state equal."""
    small = dict(img_size=32, num_classes=16, depth=2) if name == "deit_tiny" else \
        dict(img_size=32, num_classes=16, depths=(2, 2), num_heads=(2, 4), window_size=4, embed_dim=32)
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((4, 32, 32, 3)).astype(np.float32)).to(dev)
    t = torch.full((4, 16), 1 / 16, device=dev)
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


# multi-GPU: the ranks of tests/torch_parallel_worker.py on the card
TP_TINY = dict(img_size=16, patch_size=8, embed_dim=64, depth=2, num_heads=4, num_classes=16)


def _tp_case():
    art = synthetic_vit_artifact("deit_tiny", seed=1, **TP_TINY)
    images = np.random.default_rng(8).standard_normal((4, 16, 16, 3)).astype(np.float32)
    return art, images, build_vit_infer(art, "cpu", kernels=())(torch.from_numpy(images)).numpy()


def test_nccl_world_of_one(dev, tmp_path):
    """A world of one over nccl: the engine on a (1, 1) mesh (its
    all-reduces and gathers over one-rank nccl groups) equal to the plain
    engine on the CPU with 2 K1 + 5 K3 + 2 K9 launches a forward; a ZeRO-1 step
    on it equal bit for bit to the single-process step."""
    from torch_parallel_worker import run_ranks, serve_on_card

    art, images, cpu = _tp_case()
    targets = np.full((4, 8), 0.1 / 8, np.float32)
    targets[np.arange(4), [1, 5, 0, 7]] += 0.9
    spec = {"model": "deit_tiny", "model_kw": dict(QAT_TINY, drop_path_rate=0.1), "lr": 1e-3,
            "batches": [(images, targets, 5)]}
    [r] = run_ranks(1, tmp_path, serve_on_card, art, images, (1, 1), spec, backend="nccl", device="cuda")
    np.testing.assert_array_equal(r["logits"], cpu)
    assert r["launches"] == {"K1": 2, "K3": 5, "K9": 2}
    for name, p in r["plain"].items():
        assert torch.equal(r["zero1"][name], p), name


def test_two_gloo_ranks_share_the_card_tp2(dev, tmp_path):
    """Two ranks on cuda:0 over an explicitly named gloo group (the
    collectives staged through the host): tensor-parallel tiny DeiT on
    K1 + K3 + K9, each rank's logits equal to the plain engine on the CPU,
    each rank launching 2 K1 (on its 2 of 4 heads) + 5 K3 (full rows) +
    2 K9 (on its half of fc1's columns) a forward."""
    from torch_parallel_worker import run_ranks, serve_on_card

    art, images, cpu = _tp_case()
    ranks = run_ranks(2, tmp_path, serve_on_card, art, images, (1, 2), backend="gloo", device="cuda")
    for r in ranks:
        assert r["device"] == "cuda:0" and r["kernels"] == ["attention", "gelu_stable", "layernorm"]
        np.testing.assert_array_equal(r["logits"], cpu)
        assert r["launches"] == {"K1": 2, "K3": 5, "K9": 2}


# the tiny DeiT of tests/test_torch_parallel_tp_train.py: 17 tokens, 4 heads
TP_TRAIN_VIT = dict(img_size=16, patch_size=4, num_classes=8, embed_dim=32, depth=2, num_heads=4,
                    drop_rate=0.1, attn_drop_rate=0.1, drop_path_rate=0.1)


@pytest.mark.parametrize("seq", [False, True], ids=["tp", "sp"])
def test_two_gloo_ranks_train_tensor_parallel_on_the_card(dev, tmp_path, seq):
    """Two ranks on cuda:0 over gloo take two tensor-parallel QAT steps
    (sequence-parallel with ``sp``: 17 tokens as 9 and 8): both steps'
    logits and every range equal the single-process step's on the card,
    tolerance 0; the first gradient within 1e-5 of each leaf's largest
    entry (the model group's float32 sums in another order)."""
    from torch_parallel_worker import run_ranks, tp_variant, train_tp

    rng = np.random.default_rng(21)
    batches = []
    for i in range(2):
        t = np.full((8, 8), 0.1 / 8, np.float32)
        t[np.arange(8), rng.integers(0, 8, 8)] += 0.9
        batches.append((rng.standard_normal((8, 16, 16, 3)).astype(np.float32), t, 1000 + i))
    spec = {"model": "deit_tiny", "model_kw": TP_TRAIN_VIT, "lr": 1e-3, "wd": 0.05, "ema": 0.9, "clip": 1.0,
            "batches": batches, "device": "cuda", "seq": seq}
    single = tp_variant(spec, None)
    ranks = run_ranks(2, tmp_path, train_tp, [(spec, (1, 2))], backend="gloo", device="cuda")
    for r in (rk[0] for rk in ranks):
        for i, ref in enumerate(single["steps"]):
            torch.testing.assert_close(r["steps"][i]["logits"], ref["logits"], rtol=0, atol=0, msg=f"step {i}")
            for name, b in ref["ranges"].items():
                assert torch.equal(r["steps"][i]["ranges"][name], b), (i, name)
        for name, g in single["grads"].items():
            torch.testing.assert_close(r["grads"][name], g, rtol=0, atol=1e-5 * float(g.abs().max()), msg=name)


def test_int_mm_on_a_dropped_graphs_stream_stays_exact(dev):
    """The suspect of the sporadic QAT-forward mismatch (``ROADMAP.md``
    §3): a cuBLAS(Lt) workspace handed out from a CUDA graph's private
    pool and reused after the graph is dropped. A graph is captured on a
    fresh side stream with no warm-up there (so whatever that stream's
    first GEMM allocates, it allocates in the graph's pool), replayed and
    dropped, the cache emptied and the freed memory refilled with noise;
    then the same GEMMs run on that stream and on the default stream,
    100 times each, exact against float64."""
    import gc

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
