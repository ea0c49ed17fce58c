"""Swin configurations and the window geometry helpers.

Counterpart of ``ivit_tpu/models/swin.py``: the factories at its end
(``swin_tiny_patch4_window7_224`` and its siblings) and its four helpers.
The port runs frozen artifacts only, so a model here is its
configuration dict — the keys ``freeze_swin`` records under
``artifact["config"]`` (``ivit_tpu/deploy/swin_engine.py:65-75``).
"""

from __future__ import annotations

import functools
from functools import partial

import numpy as np
import torch


def swin_config(
    img_size: int = 224,
    patch_size: int = 4,
    num_classes: int = 1000,
    embed_dim: int = 96,
    depths=(2, 2, 6, 2),
    num_heads=(3, 6, 12, 24),
    window_size: int = 7,
    mlp_ratio: float = 4.0,
    gelu_stable: bool = False,
) -> dict:
    """The artifact ``config`` dict of a SwinTransformer."""
    return dict(
        img_size=img_size,
        patch_size=patch_size,
        embed_dim=embed_dim,
        depths=tuple(depths),
        num_heads=tuple(num_heads),
        window_size=window_size,
        mlp_ratio=mlp_ratio,
        num_classes=num_classes,
        gelu_stable=gelu_stable,
    )


swin_tiny_patch4_window7_224 = partial(swin_config, embed_dim=96, depths=(2, 2, 6, 2), num_heads=(3, 6, 12, 24))
swin_small_patch4_window7_224 = partial(swin_config, embed_dim=96, depths=(2, 2, 18, 2), num_heads=(3, 6, 12, 24))
swin_base_patch4_window7_224 = partial(swin_config, embed_dim=128, depths=(2, 2, 18, 2), num_heads=(4, 8, 16, 32))


def stage_geometry(cfg: dict, stage: int, block: int) -> tuple[int, int, int]:
    """``(res, ws, shift)`` of a block: the stage's grid side, the window
    (clamped to the grid) and the cyclic shift (odd blocks, unless one
    window covers the grid), as ``freeze_swin`` sets them."""
    res = cfg["img_size"] // cfg["patch_size"] // 2**stage
    ws = min(cfg["window_size"], res)
    shift = 0 if block % 2 == 0 or res <= cfg["window_size"] else cfg["window_size"] // 2
    return res, ws, shift


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) → (B·nW, ws·ws, C), contiguous."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // ws, ws, W // ws, ws, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, C)


def window_reverse(x: torch.Tensor, ws: int, H: int, W: int) -> torch.Tensor:
    """(B·nW, ws·ws, C) → (B, H, W, C), contiguous."""
    C = x.shape[-1]
    B = x.shape[0] // ((H // ws) * (W // ws))
    x = x.reshape(B, H // ws, W // ws, ws, ws, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, C)


@functools.lru_cache(maxsize=None)
def relative_position_index(ws: int) -> np.ndarray:
    """Static (ws², ws²) index into the (2ws−1)² relative-position bias
    table."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]  # (2, N, N)
    rel = rel.transpose(1, 2, 0) + (ws - 1)
    return (rel[..., 0] * (2 * ws - 1) + rel[..., 1]).astype(np.int32)


@functools.lru_cache(maxsize=None)
def sw_attn_mask(H: int, W: int, ws: int, shift: int) -> np.ndarray | None:
    """Static shifted-window mask (nW, ws², ws²) of {0, −100}; ``None``
    without a shift."""
    if shift == 0:
        return None
    img = np.zeros((1, H, W, 1), np.float32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[:, hs, wsl, :] = cnt
            cnt += 1
    win = img.reshape(1, H // ws, ws, W // ws, ws, 1)
    win = win.transpose(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws)
    diff = win[:, None, :] - win[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)
