"""Threaded, prefetching host data loader with sharding.

Counterpart of ``ivit_tpu/data/loader.py``: the same samplers, the same
per-sample generators (seeded by ``(seed, epoch, position, index)``)
and the same batches. Decode and augmentation run in a host thread pool
(or, with ``use_processes``, spawned worker processes) while the device
runs the step; batches come out as numpy arrays, and the caller moves
them to its device.

``RepeatAugSampler`` is the RASampler analogue: each epoch every
selected image appears ``num_repeats`` times (with independent
augmentations), sharded, epoch-seeded shuffle.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator

import numpy as np


class RepeatAugSampler:
    """Epoch-seeded shuffle, each sample repeated ``num_repeats`` times,
    then sharded to ``num_shards`` hosts."""

    def __init__(self, n: int, num_repeats: int = 3, shard: int = 0, num_shards: int = 1, seed: int = 0):
        self.n = n
        self.num_repeats = num_repeats
        self.shard = shard
        self.num_shards = num_shards
        self.seed = seed

    def epoch_indices(self, epoch: int) -> np.ndarray:
        rng = np.random.default_rng(self.seed + epoch)
        order = rng.permutation(self.n)
        rep = np.repeat(order, self.num_repeats)
        # pad to a multiple of num_shards, then interleave-shard
        total = int(np.ceil(len(rep) / self.num_shards)) * self.num_shards
        rep = np.concatenate([rep, rep[: total - len(rep)]])
        mine = rep[self.shard :: self.num_shards]
        # keep only ceil(n / num_shards) per epoch (RASampler truncation)
        return mine[: int(np.ceil(self.n / self.num_shards))]


class ShuffleSampler:
    """Plain epoch-seeded shuffle with sharding (RandomSampler +
    DistributedSampler semantics)."""

    def __init__(self, n: int, shard: int = 0, num_shards: int = 1, seed: int = 0, shuffle: bool = True):
        self.n = n
        self.shard = shard
        self.num_shards = num_shards
        self.seed = seed
        self.shuffle = shuffle

    def epoch_indices(self, epoch: int) -> np.ndarray:
        order = np.random.default_rng(self.seed + epoch).permutation(self.n) if self.shuffle else np.arange(self.n)
        return order[self.shard :: self.num_shards]


def _load(dataset, transform, seed: int, epoch: int, pos: int, idx: int):
    """One sample: load, then transform with its own generator."""
    arr, label = dataset.load(idx)
    return transform(arr, np.random.default_rng((seed, epoch, pos, idx))), label


# process workers (spawn): the state is installed once per worker by the
# pool's initializer; the task function is module-level so it pickles
_MP_STATE: dict = {}


def _mp_init(dataset, transform, seed, epoch):
    _MP_STATE.update(dataset=dataset, transform=transform, seed=seed, epoch=epoch)


def _mp_load(args):
    pos, idx = args
    s = _MP_STATE
    return _load(s["dataset"], s["transform"], s["seed"], s["epoch"], pos, int(idx))


class DataLoader:
    """Iterable over (images[B,H,W,C] f32, labels[B] i32) numpy batches."""

    def __init__(self, dataset, batch_size: int, transform: Callable, sampler=None, drop_last: bool = True,
                 num_workers: int = 8, prefetch: int = 4, seed: int = 0, use_processes: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.transform = transform
        self.sampler = sampler or ShuffleSampler(len(dataset), seed=seed)
        self.drop_last = drop_last
        # 0 means "no parallelism" in the torch idiom; a 0-worker
        # executor would raise, so clamp to one worker thread
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.seed = seed
        self.epoch = 0
        # worker processes sidestep the GIL for the transforms; spawned,
        # so they need a picklable dataset and transform
        # (transforms.TrainTransform / EvalTransform)
        self.use_processes = use_processes

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        n = len(self.sampler.epoch_indices(0))
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator:
        indices = self.sampler.epoch_indices(self.epoch)
        nb = len(self)
        out_q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        epoch = self.epoch

        def load_one(args):
            pos, idx = args
            return _load(self.dataset, self.transform, self.seed, epoch, pos, int(idx))

        def make_pool():
            if self.use_processes:
                import multiprocessing as mp
                from concurrent.futures import ProcessPoolExecutor

                return ProcessPoolExecutor(self.num_workers, mp_context=mp.get_context("spawn"),
                                           initializer=_mp_init,
                                           initargs=(self.dataset, self.transform, self.seed, epoch))
            return ThreadPoolExecutor(self.num_workers)

        load = _mp_load if self.use_processes else load_one

        def producer():
            try:
                with make_pool() as pool:
                    for b in range(nb):
                        if stop.is_set():
                            return
                        batch_idx = indices[b * self.batch_size : (b + 1) * self.batch_size]
                        results = list(pool.map(load, [(b * self.batch_size + j, i) for j, i in enumerate(batch_idx)]))
                        images = np.stack([r[0] for r in results]).astype(np.float32)
                        labels = np.asarray([r[1] for r in results], np.int32)
                        out_q.put((images, labels))
            except BaseException as e:  # noqa: BLE001 — handed to the consumer, which raises it:
                # a swallowed producer error would look like an empty epoch
                out_q.put(e)
            finally:
                out_q.put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = out_q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            # a consumer that stops early (a truncated epoch) drains the
            # queue, so the producer sees the stop and ends with its pool
            stop.set()
            while t.is_alive():
                try:
                    out_q.get(timeout=0.05)
                except queue.Empty:
                    pass


def build_dataloaders(args, dataset_train, dataset_val, num_shards=1, shard=0):
    """Train: shuffled (or repeated-aug) sampling with drop_last; val:
    sequential, with a 1.5× batch."""
    from .transforms import EvalTransform, TrainTransform

    tf_train = TrainTransform(
        size=args.input_size,
        color_jitter_strength=args.color_jitter,
        reprob=args.reprob,
        crop_scale=(getattr(args, "min_crop_scale", 0.08), 1.0),
        use_rand_augment=getattr(args, "aa", "rand") not in ("", "none"),
    )
    tf_eval = EvalTransform(size=args.input_size)
    use_procs = bool(getattr(args, "loader_procs", False))
    if getattr(args, "repeated_aug", False):
        sampler = RepeatAugSampler(len(dataset_train), shard=shard, num_shards=num_shards, seed=args.seed)
    else:
        sampler = ShuffleSampler(len(dataset_train), shard=shard, num_shards=num_shards, seed=args.seed)
    train_loader = DataLoader(dataset_train, args.batch_size, tf_train, sampler=sampler, drop_last=True,
                              num_workers=args.num_workers, seed=args.seed, use_processes=use_procs)
    val_loader = DataLoader(dataset_val, int(args.batch_size * 1.5), tf_eval,
                            sampler=ShuffleSampler(len(dataset_val), shard=shard, num_shards=num_shards,
                                                   shuffle=False),
                            drop_last=False, num_workers=args.num_workers, seed=args.seed, use_processes=use_procs)
    return train_loader, val_loader
