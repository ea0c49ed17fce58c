"""Model registry: name → configuration factory, the QAT models and the
float models.

Counterpart of ``ivit_tpu/models/registry.py``: ``MODEL_REGISTRY`` holds
the integer-only ViT/DeiT and Swin families, whose ``create_config``
gives a model's artifact ``config`` dict; ``FLOAT_REGISTRY`` the eight
``*_fp32`` float baselines on the same weights. ``create_model`` builds
either: the QAT ``VisionTransformer`` or ``SwinTransformer``, or the
``FloatVisionTransformer`` or ``FloatSwinTransformer``.
"""

from __future__ import annotations

import functools

import torch

from ..core.device import target_device
from . import swin, swin_float, vit, vit_float

MODEL_REGISTRY = {
    "deit_tiny": vit.deit_tiny_patch16_224,
    "deit_small": vit.deit_small_patch16_224,
    "deit_base": vit.deit_base_patch16_224,
    "vit_base": vit.vit_base_patch16_224,
    "vit_large": vit.vit_large_patch16_224,
    "swin_tiny": swin.swin_tiny_patch4_window7_224,
    "swin_small": swin.swin_small_patch4_window7_224,
    "swin_base": swin.swin_base_patch4_window7_224,
}

FLOAT_REGISTRY = {
    "deit_tiny_fp32": vit_float.deit_tiny_fp32,
    "deit_small_fp32": vit_float.deit_small_fp32,
    "deit_base_fp32": vit_float.deit_base_fp32,
    "vit_base_fp32": vit_float.vit_base_fp32,
    "vit_large_fp32": vit_float.vit_large_fp32,
    "swin_tiny_fp32": swin_float.swin_tiny_fp32,
    "swin_small_fp32": swin_float.swin_small_fp32,
    "swin_base_fp32": swin_float.swin_base_fp32,
}

# model arguments that are not part of the artifact config
_TRAIN_ONLY = ("in_chans", "qkv_bias", "drop_rate", "attn_drop_rate", "drop_path_rate", "ape", "remat")


def create_config(name: str, **kwargs) -> dict:
    """The configuration of registered model ``name``; keyword arguments
    override its fields."""
    if name not in MODEL_REGISTRY:
        raise KeyError(f"unknown model {name!r}; available: {sorted(MODEL_REGISTRY) + sorted(FLOAT_REGISTRY)}")
    return MODEL_REGISTRY[name](**kwargs)


def create_model(name: str, device="cuda", seed: int = 0, **kwargs) -> torch.nn.Module:
    """The QAT or float model of registered model ``name`` on ``device``,
    its parameters drawn on the CPU from ``seed`` (flax's initializers:
    truncated normals of std 0.02, zero biases, unit LayerNorm scales),
    so a model on the card and one on the CPU start equal. Keyword
    arguments override config fields or set the model's own (the drop
    rates, ``remat``; for a Swin ``ape``). The defaults are JAX's: a
    QAT Swin's drop-path rate is 0.1, a ViT's and the float models' 0.
    A float model takes no ``softmax_bits``, ``gelu_stable`` or ``remat``
    (JAX's float models have none; ``ValueError``). Raises for a CUDA
    device on a machine without one."""
    device = target_device(device)
    if name in FLOAT_REGISTRY:
        if "remat" in kwargs:
            raise ValueError(f"{name}: the float models take no remat (JAX's have none)")
        build = functools.partial(FLOAT_REGISTRY[name], **kwargs)
    else:
        own = {k: kwargs.pop(k) for k in _TRAIN_ONLY if k in kwargs}
        cfg = create_config(name, **kwargs)
        cls = swin.SwinTransformer if "depths" in cfg else vit.VisionTransformer
        build = functools.partial(cls, **cfg, **own)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = build()
    return model.to(device)
