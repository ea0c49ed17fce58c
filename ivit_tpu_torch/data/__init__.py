"""The input pipeline: datasets, transforms and the host data loader.

Counterpart of ``ivit_tpu/data/``. Images are uint8 HWC numpy arrays
from the dataset to the end of the transforms; Pillow is imported only
where an op needs it (``ImageFolder.load``, RandAugment and colour
jitter), so the pipeline with ``--aa none --color-jitter 0`` runs on a
machine without it.
"""

from .datasets import Cifar100, ImageFolder, SyntheticDataset, build_dataset
from .loader import DataLoader, RepeatAugSampler, ShuffleSampler, build_dataloaders
from .transforms import eval_transform, resize_bicubic, train_transform

__all__ = [
    "Cifar100",
    "DataLoader",
    "ImageFolder",
    "RepeatAugSampler",
    "ShuffleSampler",
    "SyntheticDataset",
    "build_dataloaders",
    "build_dataset",
    "eval_transform",
    "resize_bicubic",
    "train_transform",
]
