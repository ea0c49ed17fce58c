"""Model registry: name → configuration factory.

Counterpart of ``ivit_tpu/models/registry.py`` for the integer-only
ViT/DeiT and Swin families (the float models come with their slice).
"""

from __future__ import annotations

from . import swin, vit

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


def create_config(name: str, **kwargs) -> dict:
    """The configuration of registered model ``name``; keyword arguments
    override its fields."""
    if name not in MODEL_REGISTRY:
        raise KeyError(f"unknown model {name!r}; available: {sorted(MODEL_REGISTRY)}")
    return MODEL_REGISTRY[name](**kwargs)
