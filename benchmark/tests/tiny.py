"""Cells of ``BENCHMARK.json`` cut to a size the CPU tests can hold: every
file as committed, with the model's widths and depth, the batch and the
pool made small."""

from __future__ import annotations

import time

import torch

from benchmark import run as bench_run
from benchmark import spec

TINY_MODELS = {
    "vit": dict(img_size=32, patch_size=8, embed_dim=64, depth=3, num_heads=2, num_classes=10),
    "swin": dict(img_size=32, patch_size=2, embed_dim=16, depths=[2, 2, 2, 2], num_heads=[1, 2, 4, 8],
                 window_size=4, num_classes=10),
}


def tiny_cell(name: str, root: str = spec.ROOT) -> spec.Cell:
    cell = spec.load(name, root)
    cell.config["model"].update(TINY_MODELS[cell.config["family"]])
    cell.traffic.update(batch=min(cell.traffic["batch"], 8), pool=min(cell.traffic["pool"], 4),
                        warmup=min(cell.traffic.get("warmup", 0), 4), trace_units=2)
    return cell


def execute(cell: spec.Cell, seed: int = 2**31 + 11, seconds: float = 0.3, trace: bool = False,
            device: str = "cpu") -> dict:
    """A whole run of ``cell`` past the look for a card: set-up, the
    window, the comparison."""
    run = bench_run.Run(cell, seed, seconds, trace, torch.device(device), time.perf_counter())
    return bench_run.execute(run)
