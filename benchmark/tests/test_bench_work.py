"""Work counts against hand counts at DeiT-S and Swin-T shapes."""

import pytest

from benchmark import peaks, spec

DEIT_S = dict(img_size=224, patch_size=16, embed_dim=384, depth=12, num_heads=6, mlp_ratio=4.0, num_classes=1000)
SWIN_T = dict(img_size=224, patch_size=4, embed_dim=96, depths=(2, 2, 6, 2), num_heads=(3, 6, 12, 24),
              window_size=7, mlp_ratio=4.0, num_classes=1000)


def _work(name):
    return spec.load_module("work", name)


def test_k1_bytes_and_operations():
    launches = _work("K1").launches(DEIT_S, 128)
    assert len(launches) == 12
    # q, k, v in and the context out, int8, at (768, 197, 64)
    assert launches[0] == (4 * 768 * 197 * 64, 4 * 768 * 197 * 197 * 64) == (38_731_776, 7_630_159_872)
    assert launches[0][0] / peaks.HBM_BYTES * 1e3 == pytest.approx(0.01156, abs=5e-6)


def test_k3_bytes():
    deit = _work("K3").launches(DEIT_S, 128)
    assert len(deit) == 25 and len(_work("K3").launches(SWIN_T, 128)) == 28
    # int16 (25216, 384) in, int8 out, float32 beta and ratio
    assert deit[0] == (29_051_904, 0) and deit[-1] == (128 * 384 * 3 + 384 * 8, 0)
    assert deit[0][0] / peaks.HBM_BYTES * 1e3 == pytest.approx(0.008672, abs=5e-7)


def test_k7_bytes():
    launches = _work("K7").launches(SWIN_T, 128)
    assert len(launches) == 12
    unmasked, masked = launches[0][0], launches[1][0]
    assert unmasked == 4 * 24576 * 49 * 32 + 3 * 49 * 49 * 4 == 154_169_484
    assert masked == unmasked + 64 * 49 * 49 * 4 == 154_784_140
    assert unmasked / peaks.HBM_BYTES * 1e3 == pytest.approx(0.04602, abs=5e-6)
    # the last stage has one window: no shift
    assert launches[-1][0] == 4 * 128 * 24 * 49 * 32 + 24 * 49 * 49 * 4


def test_model_operations():
    n, d, h = 197, 384, 1536
    block = n * d * 3 * d + 2 * n * n * d + n * d * d + 2 * n * d * h
    assert _work("vit").forward_ops(DEIT_S) == 2 * (196 * 768 * 384 + 12 * block + 384 * 1000) == 9_197_764_608
    assert _work("swin").forward_ops(SWIN_T) == 8_981_133_312
