"""The port's input pipeline against the JAX package's on the CPU,
tolerance 0: datasets, ``resize_bicubic`` against Pillow, the train and
eval transforms, the samplers and the loader's batches; and the path
with ``--aa none --color-jitter 0`` without Pillow.

Both sides get the same uint8 pixels (the JAX side as
``Image.fromarray``) and generators seeded alike, so equal draws must
give equal arrays.
"""

import os
import pickle
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
from PIL import Image

from ivit_tpu.data import datasets as jax_datasets
from ivit_tpu.data import loader as jax_loader
from ivit_tpu.data import transforms as jax_transforms
from ivit_tpu_torch.data import datasets, loader, transforms
from ivit_tpu_torch.data.transforms import resize_bicubic
from tests.torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pixels(seed, h, w, smooth=False):
    rng = np.random.default_rng(seed)
    if smooth:  # a gradient plus noise: resampling rounds near every half
        y, x = np.mgrid[0:h, 0:w]
        base = (x * 255.0 / max(w - 1, 1) + y * 97.0 / max(h - 1, 1))[..., None] + np.array([0, 60, 120])
        return (np.mod(base, 256) + rng.integers(-3, 4, (h, w, 3))).clip(0, 255).astype(np.uint8)
    return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)


@pytest.mark.parametrize("seed", range(8))
def test_resize_bicubic_equals_pillow(seed):
    """Up- and down-scales, whole images and boxes (integer and
    fractional, touching the edges and inside), each against Pillow's
    ``Image.resize(size, BICUBIC, box=...)``."""
    rng = np.random.default_rng(100 + seed)
    for trial in range(12):
        h, w = (int(v) for v in rng.integers(1, 320, 2))
        arr = _pixels(seed * 100 + trial, h, w, smooth=trial % 2 == 0)
        size = tuple(int(v) for v in rng.integers(1, 320, 2))
        box = None
        if trial % 3:
            x0, y0 = int(rng.integers(0, w)), int(rng.integers(0, h))
            box = (x0, y0, int(rng.integers(x0 + 1, w + 1)), int(rng.integers(y0 + 1, h + 1)))
            if trial % 3 == 2:
                box = (box[0] + 0.25, box[1] + 0.5, box[2], box[3])
                if box[0] >= box[2] or box[1] >= box[3]:
                    box = (0, 0, w, h)
        ref = np.asarray(Image.fromarray(arr).resize(size, Image.BICUBIC, box=box))
        got = resize_bicubic(arr, size, box)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, ref, err_msg=f"{(h, w)} -> {size} box {box}")


@pytest.mark.parametrize("case", ["same-size", "crop-only", "rows-only", "cols-only"])
def test_resize_bicubic_pass_selection(case):
    """Pillow runs a pass only where the size or the box changes along
    that axis; a box of the output's size at integer offsets is a crop."""
    arr = _pixels(7, 40, 60, smooth=True)
    size, box = {"same-size": ((60, 40), None), "crop-only": ((20, 10), (5, 7, 25, 17)),
                 "rows-only": ((60, 25), None), "cols-only": ((33, 40), None)}[case]
    ref = np.asarray(Image.fromarray(arr).resize(size, Image.BICUBIC, box=box))
    np.testing.assert_array_equal(resize_bicubic(arr, size, box), ref)


@pytest.mark.parametrize("size", [224, 32])
def test_synthetic_dataset_equals_jax(size):
    ours, theirs = datasets.SyntheticDataset(40, size, 1000), jax_datasets.SyntheticDataset(40, size, 1000)
    for idx in (0, 1, 17, 39):
        (a, la), (img, lb) = ours.load(idx), theirs.load(idx)
        assert a.dtype == np.uint8 and la == lb
        np.testing.assert_array_equal(a, np.asarray(img))
    for train in (True, False):
        for name in ("SYNTHETIC", "synthetic"):
            ds = datasets.build_dataset(name, None, train, size, 10)
            assert len(ds) == len(jax_datasets.build_dataset(name, None, train, size, 10))


def test_cifar100_and_image_folder_equal_jax(tmp_path):
    rng = np.random.default_rng(3)
    root = tmp_path / "cifar" / "cifar-100-python"
    root.mkdir(parents=True)
    for split, n in (("train", 6), ("test", 4)):
        with open(root / split, "wb") as f:
            pickle.dump({b"data": rng.integers(0, 256, (n, 3 * 32 * 32), dtype=np.uint8),
                         b"fine_labels": list(rng.integers(0, 100, n))}, f)
    for train in (True, False):
        ours = datasets.build_dataset("CIFAR100", str(tmp_path / "cifar"), train)
        theirs = jax_datasets.build_dataset("CIFAR100", str(tmp_path / "cifar"), train)
        assert len(ours) == len(theirs)
        for idx in range(len(ours)):
            (a, la), (img, lb) = ours.load(idx), theirs.load(idx)
            assert la == lb and a.flags["C_CONTIGUOUS"]
            np.testing.assert_array_equal(a, np.asarray(img))
    for cls in ("b_class", "a_class"):
        d = tmp_path / "imnet" / "val" / cls
        d.mkdir(parents=True)
        for i in range(2):
            Image.fromarray(_pixels(i, 20 + i, 30)).save(d / f"{i}.png")
        Image.fromarray(_pixels(9, 12, 12)[..., 0]).save(d / "gray.png")  # a one-channel file
    ours = datasets.build_dataset("IMNET", str(tmp_path / "imnet"), False)
    theirs = jax_datasets.build_dataset("IMNET", str(tmp_path / "imnet"), False)
    assert ours.samples == theirs.samples and ours.class_to_idx == theirs.class_to_idx
    for idx in range(len(ours)):
        (a, la), (img, lb) = ours.load(idx), theirs.load(idx)
        assert la == lb and a.shape[-1] == 3
        np.testing.assert_array_equal(a, np.asarray(img.convert("RGB")))


@pytest.mark.parametrize("size", [224, 32])
@pytest.mark.parametrize("aug", ["randaugment", "jitter", "none"])
def test_train_transform_equals_jax(size, aug):
    """Several seeds and source shapes (larger, smaller and of another
    aspect than the output), RandAugment on, colour jitter on, or both
    off (the Pillow-free path); the erasing probability raised so it
    fires."""
    kw = dict(size=size, use_rand_augment=aug == "randaugment",
              color_jitter_strength=0.4 if aug == "jitter" else 0.0, reprob=0.5)
    shapes = [(300, 240), (180, 200), (size, size)] if size > 32 else [(32, 32), (40, 36)]
    for seed in range(4):
        for h, w in shapes:
            arr = _pixels(seed, h, w, smooth=seed % 2 == 0)
            ours = transforms.train_transform(arr, np.random.default_rng((seed, h)), **kw)
            theirs = jax_transforms.train_transform(Image.fromarray(arr), np.random.default_rng((seed, h)), **kw)
            assert ours.dtype == np.float32
            np.testing.assert_array_equal(ours, theirs, err_msg=f"seed {seed} {(h, w)}")


@pytest.mark.parametrize("size", [224, 32])
def test_eval_transform_equals_jax(size):
    shapes = [(300, 240), (240, 300), (224, 224), (100, 50)] if size > 32 else [(32, 32), (48, 40)]
    for i, (h, w) in enumerate(shapes):
        arr = _pixels(i, h, w, smooth=True)
        np.testing.assert_array_equal(transforms.eval_transform(arr, size),
                                      jax_transforms.eval_transform(Image.fromarray(arr), size))
    arr = _pixels(5, 300, 280)
    np.testing.assert_array_equal(transforms.EvalTransform(size, crop_pct=0.9)(arr),
                                  jax_transforms.EvalTransform(size, crop_pct=0.9)(Image.fromarray(arr)))


@pytest.mark.parametrize("shards", [1, 3])
def test_samplers_equal_jax(shards):
    for epoch in (0, 1, 5):
        for shard in range(shards):
            for kw in (dict(num_repeats=3, seed=2), dict(seed=2), dict(shuffle=False)):
                cls = "RepeatAugSampler" if "num_repeats" in kw else "ShuffleSampler"
                ours = getattr(loader, cls)(50, shard=shard, num_shards=shards, **kw)
                theirs = getattr(jax_loader, cls)(50, shard=shard, num_shards=shards, **kw)
                np.testing.assert_array_equal(ours.epoch_indices(epoch), theirs.epoch_indices(epoch))


def _loader_args(**kw):
    return SimpleNamespace(**{**dict(input_size=32, color_jitter=0.4, reprob=0.25, min_crop_scale=0.08,
                                     aa="rand-m9-mstd0.5-inc1", loader_procs=False, repeated_aug=False, seed=3,
                                     batch_size=4, num_workers=2), **kw})


@pytest.mark.parametrize("variant", ["randaugment", "repeated-aug", "pillow-free-224"])
def test_loader_batches_equal_jax(variant):
    """``build_dataloaders`` on the synthetic set: every train batch of
    two epochs and every val batch (its ragged last one included) equal
    to JAX's."""
    kw = {"randaugment": {}, "repeated-aug": dict(repeated_aug=True, aa="none"),
          "pillow-free-224": dict(input_size=224, aa="none", color_jitter=0.0, batch_size=6)}[variant]
    args = _loader_args(**kw)
    n = 18 if args.input_size == 224 else 26
    size = args.input_size
    ours = loader.build_dataloaders(args, datasets.SyntheticDataset(n, size, 10),
                                    datasets.SyntheticDataset(n // 2, size, 10))
    theirs = jax_loader.build_dataloaders(args, jax_datasets.SyntheticDataset(n, size, 10),
                                          jax_datasets.SyntheticDataset(n // 2, size, 10))
    for a, b in zip(ours, theirs):
        assert len(a) == len(b)
    for epoch in (0, 1):
        ours[0].set_epoch(epoch)
        theirs[0].set_epoch(epoch)
        batches = list(zip(ours[0], theirs[0], strict=True))
        assert len(batches) == len(ours[0]) > 0
        for (xa, ya), (xb, yb) in batches:
            assert xa.dtype == np.float32 and ya.dtype == np.int32
            np.testing.assert_array_equal(xa, xb)
            np.testing.assert_array_equal(ya, yb)
    val = list(zip(ours[1], theirs[1], strict=True))
    assert sum(len(y) for (_, y), _ in val) == n // 2
    for (xa, ya), (xb, yb) in val:
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(ya, yb)


def test_process_loader_equals_thread_loader():
    """Spawned worker processes give the thread loader's batches."""
    ds = datasets.SyntheticDataset(8, 32, 10)
    tf = transforms.TrainTransform(size=32, use_rand_augment=False, color_jitter_strength=0.0)
    kw = dict(sampler=loader.ShuffleSampler(8, seed=1), num_workers=2, seed=1)
    threads = list(loader.DataLoader(ds, 4, tf, **kw))
    procs = list(loader.DataLoader(ds, 4, tf, use_processes=True, **kw))
    assert len(threads) == len(procs) == 2
    for (xa, ya), (xb, yb) in zip(threads, procs):
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(ya, yb)


def test_loader_raises_a_producer_error():
    class Broken(datasets.SyntheticDataset):
        def load(self, idx):
            raise OSError("unreadable image")

    with pytest.raises(OSError, match="unreadable image"):
        list(loader.DataLoader(Broken(4, 32, 10), 2, transforms.EvalTransform(32), num_workers=1))


_NO_PILLOW = """
import sys
sys.modules["PIL"] = None
sys.path.insert(0, {repo!r})
from types import SimpleNamespace
import numpy as np
from ivit_tpu_torch.data import build_dataloaders, build_dataset
from ivit_tpu_torch.data.transforms import color_jitter, rand_augment
args = SimpleNamespace(input_size=224, color_jitter=0.0, reprob=0.25, min_crop_scale=0.08, aa="none",
                       loader_procs=False, repeated_aug=False, seed=0, batch_size=4, num_workers=2)
train, val = build_dataloaders(args, build_dataset("SYNTHETIC", None, True, 224, 10),
                               build_dataset("SYNTHETIC", None, False, 224, 10))
x, y = next(iter(train))
v, _ = next(iter(val))
print("batches", x.shape, v.shape, np.isfinite(x).all(), np.isfinite(v).all())
for op in (rand_augment, color_jitter):
    try:
        op(np.zeros((8, 8, 3), np.uint8), np.random.default_rng(0))
    except ImportError as err:
        print("raised:", err)
"""


def test_pillow_free_path_runs_without_pillow():
    """With Pillow unimportable, the ``--aa none --color-jitter 0``
    loaders give their batches, and RandAugment and colour jitter raise
    an ImportError that names Pillow and the two flags."""
    run = subprocess.run([sys.executable, "-c", _NO_PILLOW.format(repo=REPO)], capture_output=True, text=True,
                         timeout=120)
    assert run.returncode == 0, run.stderr
    lines = run.stdout.strip().splitlines()
    assert lines[0] == "batches (4, 224, 224, 3) (6, 224, 224, 3) True True"
    assert len(lines) == 3
    for line in lines[1:]:
        assert line.startswith("raised:") and "Pillow" in line and "--aa none --color-jitter 0" in line
