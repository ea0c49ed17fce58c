"""The transforms that run on Pillow: RandAugment and colour jitter.

Counterpart of ``ivit_tpu/data/transforms.py:22-193`` and ``:222-230``,
op for op (timm's ``rand-m9-mstd0.5-inc1`` policy as the JAX module
audits it), on uint8 (H, W, 3) arrays: each function converts to a
Pillow image, runs the JAX package's ops, and converts back.

This module imports Pillow when it is imported; ``data.transforms``
imports it at the first RandAugment or colour-jitter call, so the rest
of the pipeline runs without Pillow.
"""

from __future__ import annotations

import numpy as np
from PIL import Image, ImageEnhance, ImageOps

_BICUBIC = Image.BICUBIC
_MAX_LEVEL = 10.0
# timm aa_params img_mean fill for geometric ops:
# tuple(min(255, round(255·x)) for x in IMAGENET_MEAN) = (124, 116, 104)
_FILL = (124, 116, 104)


def _enhance_factor(level):
    # inc1: factor grows away from identity with level
    return 1.0 + (level / _MAX_LEVEL) * 0.9


def _shear_arg(level):
    return (level / _MAX_LEVEL) * 0.3


def _translate_arg(level):
    return (level / _MAX_LEVEL) * 0.45


def _maybe_neg(v, rng):
    return -v if rng.random() < 0.5 else v


def _affine(img, matrix):
    return img.transform(img.size, Image.AFFINE, matrix, resample=_BICUBIC, fillcolor=_FILL)


def _op_autocontrast(img, level, rng):
    return ImageOps.autocontrast(img)


def _op_equalize(img, level, rng):
    return ImageOps.equalize(img)


def _op_invert(img, level, rng):
    return ImageOps.invert(img)


def _op_rotate(img, level, rng):
    deg = _maybe_neg((level / _MAX_LEVEL) * 30.0, rng)
    return img.rotate(deg, resample=_BICUBIC, fillcolor=_FILL)


def _op_posterize(img, level, rng):
    # timm PosterizeIncreasing: keep 4 − int(4·L/10) MSBs
    bits = 4 - int((level / _MAX_LEVEL) * 4)
    return ImageOps.posterize(img, bits)


def _op_solarize(img, level, rng):
    thresh = 256 - int((level / _MAX_LEVEL) * 256)
    return ImageOps.solarize(img, thresh)


def _op_solarize_add(img, level, rng):
    add = int((level / _MAX_LEVEL) * 110)
    arr = np.asarray(img, np.int32)
    arr = np.where(arr < 128, np.clip(arr + add, 0, 255), arr)
    return Image.fromarray(arr.astype(np.uint8))


def _op_color(img, level, rng):
    f = _enhance_factor(level)
    return ImageEnhance.Color(img).enhance(_maybe_neg(f - 1.0, rng) + 1.0)


def _op_contrast(img, level, rng):
    f = _enhance_factor(level)
    return ImageEnhance.Contrast(img).enhance(_maybe_neg(f - 1.0, rng) + 1.0)


def _op_brightness(img, level, rng):
    f = _enhance_factor(level)
    return ImageEnhance.Brightness(img).enhance(_maybe_neg(f - 1.0, rng) + 1.0)


def _op_sharpness(img, level, rng):
    f = _enhance_factor(level)
    return ImageEnhance.Sharpness(img).enhance(_maybe_neg(f - 1.0, rng) + 1.0)


def _op_shear_x(img, level, rng):
    s = _maybe_neg(_shear_arg(level), rng)
    return _affine(img, (1, s, 0, 0, 1, 0))


def _op_shear_y(img, level, rng):
    s = _maybe_neg(_shear_arg(level), rng)
    return _affine(img, (1, 0, 0, s, 1, 0))


def _op_translate_x(img, level, rng):
    t = _maybe_neg(_translate_arg(level) * img.size[0], rng)
    return _affine(img, (1, 0, t, 0, 1, 0))


def _op_translate_y(img, level, rng):
    t = _maybe_neg(_translate_arg(level) * img.size[1], rng)
    return _affine(img, (1, 0, 0, 0, 1, t))


_RAND_OPS = [
    _op_autocontrast,
    _op_equalize,
    _op_invert,
    _op_rotate,
    _op_posterize,
    _op_solarize,
    _op_solarize_add,
    _op_color,
    _op_contrast,
    _op_brightness,
    _op_sharpness,
    _op_shear_x,
    _op_shear_y,
    _op_translate_x,
    _op_translate_y,
]


def rand_augment(arr: np.ndarray, rng: np.random.Generator, num_ops=2, magnitude=9.0, mag_std=0.5,
                 op_prob=0.5) -> np.ndarray:
    """timm RandAugment: ``num_ops`` uniformly chosen ops, each applied
    with probability ``op_prob``, magnitude ~ N(m, mstd) clipped to
    [0, 10] drawn per op."""
    img = Image.fromarray(np.ascontiguousarray(arr))
    for _ in range(num_ops):
        op = _RAND_OPS[rng.integers(len(_RAND_OPS))]
        if rng.random() > op_prob:
            continue
        level = np.clip(rng.normal(magnitude, mag_std), 0, _MAX_LEVEL)
        img = op(img, level, rng)
    return np.asarray(img)


def color_jitter(arr: np.ndarray, rng: np.random.Generator, strength=0.4) -> np.ndarray:
    """Brightness, contrast and saturation, each by a factor drawn from
    1 ± strength."""
    img = Image.fromarray(np.ascontiguousarray(arr))
    for enhancer in (ImageEnhance.Brightness, ImageEnhance.Contrast, ImageEnhance.Color):
        f = 1.0 + rng.uniform(-strength, strength)
        img = enhancer(img).enhance(max(0.0, f))
    return np.asarray(img)
