"""Image transforms: the DeiT training recipe on uint8 HWC arrays.

Counterpart of ``ivit_tpu/data/transforms.py``: train =
RandomResizedCrop (pad-4 random crop at 32² and below) + flip +
RandAugment ``rand-m9-mstd0.5-inc1`` or colour jitter + normalize +
RandomErasing; eval = Resize(size/0.875) + CenterCrop + normalize. Each
function takes and gives what the JAX one does, with a uint8 (H, W, 3)
array in place of a Pillow image, and draws from ``rng`` in the same
order, so the two give equal arrays for the same generator.

The crops, flips, normalization and erasing are numpy, and so is the
bicubic resize (``resize_bicubic``, Pillow's resampler bit for bit).
RandAugment and colour jitter run on Pillow (``data.pil_ops``), imported
at their first call; without Pillow they raise, and
``--aa none --color-jitter 0`` trains without them.
"""

from __future__ import annotations

import math

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

# Pillow's 8-bit resampler (libImaging/Resample.c): coefficients in
# fixed point with 22 fraction bits, so a tap sum of uint8 values times
# coefficients of |sum| about 1.25 stays inside int32
_PRECISION_BITS = 32 - 8 - 2
_BICUBIC_SUPPORT = 2.0


def _pil_ops():
    try:
        from . import pil_ops
    except ImportError as err:
        raise ImportError(
            "RandAugment and colour jitter run on Pillow, which is not installed: train with "
            "--aa none --color-jitter 0 to leave them out"
        ) from err
    return pil_ops


def _bicubic_filter(x: np.ndarray) -> np.ndarray:
    """Pillow's bicubic kernel (a = −0.5), in its order of operations."""
    a = -0.5
    x = np.abs(x)
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    far = (((x - 5) * x + 8) * x - 4) * a
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


def _coefficients(in_size: int, in0: np.float32, in1: np.float32, out_size: int):
    """Pillow's ``precompute_coeffs`` + ``normalize_coeffs_8bpc``: per
    output pixel the first input pixel it reads, how many it reads, and
    the fixed-point taps (zero past the last), (out, ksize): the rows of
    the pass's coefficient matrix, by band."""
    scale = float(np.float32(in1) - np.float32(in0)) / out_size
    filterscale = max(scale, 1.0)
    support = _BICUBIC_SUPPORT * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = float(in0) + (np.arange(out_size) + 0.5) * scale
    # C's (int) truncates toward zero
    xmin = np.maximum(np.trunc(center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum(np.trunc(center + support + 0.5).astype(np.int64), in_size) - xmin
    taps = np.arange(ksize)
    live = taps[None, :] < xmax[:, None]
    w = np.where(live, _bicubic_filter(((taps[None, :] + xmin[:, None]) - center[:, None] + 0.5) * (1.0 / filterscale)),
                 0.0)
    ww = np.zeros(out_size)
    for t in range(ksize):  # Pillow sums the taps in order
        ww = ww + w[:, t]
    w = np.where(ww[:, None] != 0.0, w / np.where(ww == 0.0, 1.0, ww)[:, None], w)
    fixed = w * (1 << _PRECISION_BITS)
    kk = np.trunc(np.where(w < 0, fixed - 0.5, fixed + 0.5)).astype(np.int64)
    return xmin, xmax, np.where(live, kk, 0)


def _resample(arr: np.ndarray, axis: int, xmin: np.ndarray, kk: np.ndarray) -> np.ndarray:
    """One separable pass along ``axis`` (1: horizontal, 0: vertical):
    each output pixel is the sum of its taps times the input pixels from
    ``xmin`` on, plus a half, shifted down by the fraction bits and
    clipped to uint8. The sums are int32, as Pillow's: exact, with no
    BLAS call (OpenBLAS serializes the loader's threads), one vectorized
    multiply-add a tap."""
    n = arr.shape[axis]
    shape = list(arr.shape)
    shape[axis] = len(xmin)
    acc = np.full(shape, 1 << (_PRECISION_BITS - 1), np.int32)
    taps = [1] * arr.ndim
    taps[axis] = len(xmin)
    k = kk.astype(np.int32)
    for t in range(k.shape[1]):
        pixels = np.take(arr, np.minimum(xmin + t, n - 1), axis=axis).astype(np.int32)
        acc += pixels * k[:, t].reshape(taps)
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def resize_bicubic(arr: np.ndarray, size: tuple, box: tuple | None = None) -> np.ndarray:
    """Pillow's ``Image.resize(size, Image.BICUBIC, box=box)`` of a uint8
    (H, W, C) array, bit for bit: ``size`` is (width, height), ``box``
    (x0, y0, x1, y1) in input pixels (float32, as Pillow reads it;
    default the whole image). Pillow's passes: horizontal over the rows
    the vertical pass reads, then vertical, each only where the width or
    the height (or the box) changes; between the passes the image is
    uint8."""
    h, w = arr.shape[:2]
    out_w, out_h = size
    box = (0, 0, w, h) if box is None else box
    x0, y0, x1, y1 = (np.float32(v) for v in box)
    need_h = out_w != w or x0 != 0 or x1 != out_w
    need_v = out_h != h or y0 != 0 or y1 != out_h
    ymin, ylen, ky = _coefficients(h, y0, y1, out_h)
    out = arr
    if need_h:
        first, last = int(ymin[0]), int(ymin[-1] + ylen[-1])
        xmin, _, kx = _coefficients(w, x0, x1, out_w)
        out = _resample(arr[first:last], 1, xmin, kx)
        ymin = ymin - first
    if need_v:
        out = _resample(out, 0, ymin, ky)
    return out if (need_h or need_v) else arr.copy()


# ------------------------------------------------------------ crop / jitter


def random_resized_crop(arr, rng, size=224, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3)):
    h, w = arr.shape[:2]
    area = w * h
    for _ in range(10):
        target = rng.uniform(*scale) * area
        log_r = rng.uniform(np.log(ratio[0]), np.log(ratio[1]))
        ar = np.exp(log_r)
        cw = int(round(np.sqrt(target * ar)))
        ch = int(round(np.sqrt(target / ar)))
        if cw <= w and ch <= h:
            x0 = rng.integers(0, w - cw + 1)
            y0 = rng.integers(0, h - ch + 1)
            return resize_bicubic(arr, (size, size), box=(x0, y0, x0 + cw, y0 + ch))
    # fallback after 10 attempts — torchvision semantics: whole image,
    # center-cropped only as far as the ratio bounds require
    in_ratio = w / h
    if in_ratio < ratio[0]:
        cw, ch = w, int(round(w / ratio[0]))
    elif in_ratio > ratio[1]:
        cw, ch = int(round(h * ratio[1])), h
    else:
        cw, ch = w, h
    x0, y0 = (w - cw) // 2, (h - ch) // 2
    return resize_bicubic(arr, (size, size), box=(x0, y0, x0 + cw, y0 + ch))


def rand_augment(arr, rng, num_ops=2, magnitude=9.0, mag_std=0.5, op_prob=0.5):
    """timm RandAugment (``data.pil_ops.rand_augment``); needs Pillow."""
    return _pil_ops().rand_augment(arr, rng, num_ops, magnitude, mag_std, op_prob)


def color_jitter(arr, rng, strength=0.4):
    """Brightness, contrast and saturation jitter (``data.pil_ops``);
    needs Pillow."""
    return _pil_ops().color_jitter(arr, rng, strength)


def random_erasing(arr, rng, prob=0.25, scale=(0.02, 1 / 3), ratio=(0.3, 3.3)):
    """Per-pixel random erasing on the normalized HWC array (timm mode
    'pixel')."""
    if rng.random() >= prob:
        return arr
    h, w, c = arr.shape
    area = h * w
    for _ in range(10):
        target = rng.uniform(*scale) * area
        log_r = rng.uniform(np.log(ratio[0]), np.log(ratio[1]))
        ar = np.exp(log_r)
        eh = int(round(np.sqrt(target / ar)))
        ew = int(round(np.sqrt(target * ar)))
        if eh < h and ew < w:
            y0 = rng.integers(0, h - eh + 1)
            x0 = rng.integers(0, w - ew + 1)
            arr[y0 : y0 + eh, x0 : x0 + ew] = rng.normal(size=(eh, ew, c)).astype(np.float32)
            return arr
    return arr


# ---------------------------------------------------------------- pipelines


def normalize(arr):
    return (arr / 255.0 - IMAGENET_MEAN) / IMAGENET_STD


def pad_random_crop(arr, rng, size=32, padding=4):
    """``transforms.RandomCrop(size, padding=4)``: zero-pad every border
    by ``padding`` then crop a random ``size``² window."""
    arr = np.pad(arr, ((padding, padding), (padding, padding), (0, 0)))
    y0 = int(rng.integers(0, arr.shape[0] - size + 1))
    x0 = int(rng.integers(0, arr.shape[1] - size + 1))
    return arr[y0 : y0 + size, x0 : x0 + size]


def train_transform(arr: np.ndarray, rng: np.random.Generator, size=224, color_jitter_strength=0.4,
                    ra_magnitude=9.0, ra_mag_std=0.5, reprob=0.25, crop_scale=(0.08, 1.0),
                    use_rand_augment=True) -> np.ndarray:
    """Full DeiT train transform of a uint8 (H, W, 3) array → float32 HWC.

    ``size <= 32`` takes the pad-4 random crop in place of
    RandomResizedCrop; the rest is unchanged. RandAugment disables the
    colour jitter, as timm's ``create_transform`` does.
    """
    if size <= 32:
        arr = pad_random_crop(arr, rng, size=size, padding=4)
    else:
        arr = random_resized_crop(arr, rng, size, scale=crop_scale)
    if rng.random() < 0.5:
        arr = arr[:, ::-1]
    if use_rand_augment:
        arr = rand_augment(arr, rng, magnitude=ra_magnitude, mag_std=ra_mag_std)
    elif color_jitter_strength:
        arr = color_jitter(arr, rng, color_jitter_strength)
    out = normalize(np.asarray(arr, np.float32))
    return random_erasing(out, rng, prob=reprob)


def eval_transform(arr: np.ndarray, size=224, crop_pct=None) -> np.ndarray:
    """Resize(size/0.875) + center crop + normalize → float32 HWC. At
    ``size <= 32`` the image goes straight to normalize (resized to
    size² only if it is not already)."""
    if size <= 32:
        if arr.shape[:2] != (size, size):  # non-native source
            arr = resize_bicubic(arr, (size, size))
        return normalize(np.asarray(arr, np.float32))
    resize = int(size / (crop_pct or 0.875))
    h, w = arr.shape[:2]
    if w < h:
        nw, nh = resize, int(resize * h / w)
    else:
        nw, nh = int(resize * w / h), resize
    arr = resize_bicubic(arr, (nw, nh))
    x0, y0 = (nw - size) // 2, (nh - size) // 2
    return normalize(np.asarray(arr[y0 : y0 + size, x0 : x0 + size], np.float32))


class TrainTransform:
    """Picklable train-transform callable (process-based loader workers
    ship the transform to spawned children). Same semantics as
    :func:`train_transform`."""

    def __init__(self, size=224, color_jitter_strength=0.4, ra_magnitude=9.0, ra_mag_std=0.5, reprob=0.25,
                 crop_scale=(0.08, 1.0), use_rand_augment=True):
        self.kw = dict(size=size, color_jitter_strength=color_jitter_strength, ra_magnitude=ra_magnitude,
                       ra_mag_std=ra_mag_std, reprob=reprob, crop_scale=crop_scale,
                       use_rand_augment=use_rand_augment)

    def __call__(self, arr, rng):
        return train_transform(arr, rng, **self.kw)


class EvalTransform:
    """Picklable eval-transform callable (see :class:`TrainTransform`)."""

    def __init__(self, size=224, crop_pct=None):
        self.size = size
        self.crop_pct = crop_pct

    def __call__(self, arr, rng=None):
        return eval_transform(arr, size=self.size, crop_pct=self.crop_pct)
