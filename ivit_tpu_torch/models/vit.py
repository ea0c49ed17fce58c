"""ViT / DeiT configurations.

Counterpart of the factories at the end of ``ivit_tpu/models/vit.py``:
the port runs frozen artifacts only, so a model here is its
configuration dict — the same keys ``freeze_vit`` records under
``artifact["config"]``.
"""

from __future__ import annotations

from functools import partial


def vit_config(
    img_size: int = 224,
    patch_size: int = 16,
    num_classes: int = 1000,
    embed_dim: int = 768,
    depth: int = 12,
    num_heads: int = 12,
    mlp_ratio: float = 4.0,
    softmax_bits: int = 16,
    gelu_stable: bool = False,
) -> dict:
    """The artifact ``config`` dict of a VisionTransformer."""
    return dict(
        img_size=img_size,
        patch_size=patch_size,
        embed_dim=embed_dim,
        depth=depth,
        num_heads=num_heads,
        mlp_ratio=mlp_ratio,
        num_classes=num_classes,
        softmax_bits=softmax_bits,
        gelu_stable=gelu_stable,
    )


deit_tiny_patch16_224 = partial(vit_config, embed_dim=192, depth=12, num_heads=3)
deit_small_patch16_224 = partial(vit_config, embed_dim=384, depth=12, num_heads=6)
deit_base_patch16_224 = partial(vit_config, embed_dim=768, depth=12, num_heads=12)
vit_base_patch16_224 = partial(vit_config, embed_dim=768, depth=12, num_heads=12)
vit_large_patch16_224 = partial(vit_config, embed_dim=1024, depth=24, num_heads=16)
