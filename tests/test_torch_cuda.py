"""The port's CUDA kernels on the card: each bit-equal (tolerance 0) to its
plain torch version, and the engine's kernel path bit-equal to the CPU.

Every test here needs a CUDA device and skips without one (the kernels
have no CPU mode). The file imports no JAX, so it runs on a machine
without it; from the repository root:

    python -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest -p no:cacheprovider

(``--noconftest``: ``tests/conftest.py`` imports JAX.)
"""

import numpy as np
import pytest
import torch

from ivit_tpu_torch.deploy.engine import build_vit_infer
from ivit_tpu_torch.deploy.synthetic import synthetic_vit_artifact
from ivit_tpu_torch.kernels import (
    fused_int8_attention,
    fused_int8_attention_reference,
    fused_layernorm_requant,
    fused_layernorm_requant_reference,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _attention_case(G, N, hd, out_bits, seed):
    """int8 q, k, v with a row of tied scores and a saturated row, and
    ratios that spread the other rows over about a third of int8."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.integers(-128, 128, (G, N, hd)).astype(np.int8) for _ in range(3))
    q[0, 0] = 0
    q[0, 1] = 127
    k[0] = np.where(np.arange(N)[:, None] % 2 == 0, 127, -128)
    r1 = float(np.float32(127.0 / (3 * np.sqrt(hd) * 74.0**2)))
    r_out = float(np.float32((1.0 / 2 ** (out_bits - 1)) * 0.05 / 0.021))
    return [torch.from_numpy(a) for a in (q, k, v)], (r1, float(np.float32(0.07)), r_out)


@pytest.mark.parametrize("out_bits", [8, 16])
@pytest.mark.parametrize("shape", [(6, 197, 64), (3, 256, 128), (5, 17, 8)])
def test_attention_kernel_matches_reference(dev, shape, out_bits):
    qkv, ratios = _attention_case(*shape, out_bits, seed=out_bits)
    before = fused_int8_attention.launches
    out = fused_int8_attention(*(a.to(dev) for a in qkv), *ratios, out_bits)
    torch.cuda.synchronize()
    assert fused_int8_attention.launches == before + 1
    ref = fused_int8_attention_reference(*qkv, *ratios, out_bits)
    torch.testing.assert_close(out.cpu(), ref, rtol=0, atol=0)


@pytest.mark.parametrize("shape", [(197, 384), (33, 100), (40, 1024)])
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


@pytest.mark.parametrize("softmax_bits,gelu_stable", [(8, True), (16, False)])
def test_engine_kernel_path_matches_cpu(dev, softmax_bits, gelu_stable):
    artifact = synthetic_vit_artifact(
        "deit_tiny", seed=1, softmax_bits=softmax_bits, gelu_stable=gelu_stable,
        img_size=32, patch_size=8, embed_dim=128, depth=2, num_heads=2, num_classes=16,
    )
    images = torch.from_numpy(np.random.default_rng(2).standard_normal((3, 32, 32, 3)).astype(np.float32))
    k1, k3 = fused_int8_attention.launches, fused_layernorm_requant.launches
    logits = build_vit_infer(artifact, dev)(images)
    torch.cuda.synchronize()
    assert fused_int8_attention.launches - k1 == 2
    assert fused_layernorm_requant.launches - k3 == 5
    torch.testing.assert_close(logits.cpu(), build_vit_infer(artifact)(images), rtol=0, atol=0)
