"""Datasets: ImageFolder (ImageNet layout), CIFAR-100, synthetic.

Counterpart of ``ivit_tpu/data/datasets.py``. ``load(idx)`` returns
``(image, label)`` with the image a uint8 (H, W, 3) array: pixel for
pixel what the JAX package's ``Image`` holds after ``convert("RGB")``.
Only ``ImageFolder`` decodes files, and only it imports Pillow, when it
loads an image.
"""

from __future__ import annotations

import os
import pickle
from typing import Optional

import numpy as np

_IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")


class ImageFolder:
    """ImageNet-style directory: root/class_x/img.jpeg."""

    def __init__(self, root: str):
        self.root = root
        classes = sorted(d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d)))
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples = []
        for c in classes:
            cdir = os.path.join(root, c)
            for fn in sorted(os.listdir(cdir)):
                if fn.lower().endswith(_IMG_EXTS):
                    self.samples.append((os.path.join(cdir, fn), self.class_to_idx[c]))
        self.num_classes = len(classes)

    def __len__(self):
        return len(self.samples)

    def load(self, idx: int):
        from PIL import Image

        path, label = self.samples[idx]
        with Image.open(path) as img:
            return np.asarray(img.convert("RGB")), label


class Cifar100:
    """CIFAR-100 python-pickle format (train/test files under root)."""

    def __init__(self, root: str, train: bool = True):
        fn = os.path.join(root, "cifar-100-python", "train" if train else "test")
        with open(fn, "rb") as f:
            d = pickle.load(f, encoding="bytes")
        self.images = d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        self.labels = np.asarray(d[b"fine_labels"], np.int32)
        self.num_classes = 100

    def __len__(self):
        return len(self.labels)

    def load(self, idx: int):
        return np.ascontiguousarray(self.images[idx]), int(self.labels[idx])


class SyntheticDataset:
    """Deterministic synthetic images — for tests/benchmarks without data.

    Labels are recoverable from content (a bright square whose position
    encodes the class), so training sanity checks can actually learn,
    not just memorize noise.
    """

    def __init__(self, n: int = 512, size: int = 224, num_classes: int = 1000, seed: int = 0):
        self.n = n
        self.size = size
        self.num_classes = num_classes
        self.seed = seed

    def __len__(self):
        return self.n

    def load(self, idx: int):
        rng = np.random.default_rng(self.seed * 1_000_003 + idx)
        arr = rng.integers(0, 128, (self.size, self.size, 3), dtype=np.uint8)
        label = int(idx % self.num_classes)
        # class-coded bright square on a grid; beyond 64 position codes
        # the square's brightness level codes label // 64 (3 levels stay
        # above the 0..127 background; with more classes the level wraps
        # and classes alias, and it never overflows uint8)
        cells = max(2, int(np.ceil(np.sqrt(min(self.num_classes, 64)))))
        cs = self.size // cells
        cy, cx = divmod(label % (cells * cells), cells)
        level = 255 - 48 * ((label // (cells * cells)) % 3)
        arr[cy * cs : (cy + 1) * cs, cx * cs : (cx + 1) * cs] = level
        return arr, label


def build_dataset(name: str, data_dir: Optional[str], train: bool, img_size: int = 224, num_classes: int = 1000):
    """name ∈ {IMNET, CIFAR100, SYNTHETIC}."""
    name = name.upper()
    if name == "IMNET":
        return ImageFolder(os.path.join(data_dir, "train" if train else "val"))
    if name == "CIFAR100":
        return Cifar100(data_dir, train)
    if name == "SYNTHETIC":
        return SyntheticDataset(n=512 if train else 128, size=img_size, num_classes=num_classes)
    raise ValueError(f"unknown dataset {name!r}")
