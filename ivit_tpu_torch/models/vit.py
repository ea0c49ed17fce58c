"""Integer-only Vision Transformer (DeiT / ViT): configurations and the
QAT model.

Counterpart of ``ivit_tpu/models/vit.py``. ``vit_config`` is the artifact
``config`` dict the engines read (the keys ``freeze_vit`` records), and
the five factories at the end give it for each registered width;
``VisionTransformer`` is the QAT model those configurations build
(``models.registry.create_model``), run under the ``SIM`` interpreter:
input ``QuantAct`` → patch embed → cls concat at the patch scale →
pos-embed quantized on its own and merged in a 16-bit ``QuantAct`` →
pre-norm blocks → I-LayerNorm → CLS token → ``QuantAct`` → quantized
head, whose output is the only dequantization.

``remat=True`` recomputes each block's activations in the backward
instead of keeping them (``nn.remat``: the re-run holds the
``QuantAct`` ranges and replays the block's random draws), as JAX's
``nn.remat(Block)`` does; the values, ranges and gradients are those
without it.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import torch
from torch import nn

from ..core.qtensor import QTensor
from ..nn.quant import IntLayerNorm, QuantAct, QuantLinear, QuantPatchEmbed, trunc_normal_
from ..nn.remat import remat as remat_block
from ..nn.vit_blocks import Block, head_logits
from ..ops.interp import SIM, div


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


class VisionTransformer(nn.Module):
    """The QAT ViT on NHWC float images; returns float logits.

    ``softmax_bits`` 16 is the reference's QAT spec, 8 the precision its
    deployed graph runs; ``gelu_stable`` selects the elementwise ShiftGELU.
    Both are model properties the frozen artifact records. ``drop_rate``,
    ``attn_drop_rate`` and ``drop_path_rate`` (stochastic depth, rising
    linearly over the blocks) act only under ``train=True``. ``remat``
    recomputes each block in the backward (module docstring).
    """

    def __init__(
        self,
        img_size: int = 224,
        patch_size: int = 16,
        in_chans: int = 3,
        num_classes: int = 1000,
        embed_dim: int = 768,
        depth: int = 12,
        num_heads: int = 12,
        mlp_ratio: float = 4.0,
        qkv_bias: bool = True,
        drop_rate: float = 0.0,
        attn_drop_rate: float = 0.0,
        drop_path_rate: float = 0.0,
        softmax_bits: int = 16,
        gelu_stable: bool = False,
        remat: bool = False,
    ):
        super().__init__()
        self.remat = remat
        self.config = vit_config(img_size, patch_size, num_classes, embed_dim, depth, num_heads,
                                 mlp_ratio, softmax_bits, gelu_stable)
        num_patches = (img_size // patch_size) ** 2
        self.qact_input = QuantAct(8)
        self.patch_embed = QuantPatchEmbed(patch_size, in_chans, embed_dim)
        self.qact_embed = QuantAct(16)
        self.cls_token = nn.Parameter(trunc_normal_(torch.empty(1, 1, embed_dim), 0.02))
        self.pos_embed = nn.Parameter(trunc_normal_(torch.empty(1, num_patches + 1, embed_dim), 0.02))
        self.qact_pos = QuantAct(16)
        self.qact1 = QuantAct(16)
        # flax's names (blocks_0, ...), so torch names map onto flax paths
        self.blocks = [
            Block(embed_dim, num_heads, mlp_ratio, qkv_bias, drop_rate, attn_drop_rate, float(rate),
                  softmax_bits, gelu_stable)
            for rate in np.linspace(0.0, drop_path_rate, depth)
        ]
        for i, blk in enumerate(self.blocks):
            self.add_module(f"blocks_{i}", blk)
        self.norm = IntLayerNorm(embed_dim)
        self.qact2 = QuantAct(8)
        self.head = QuantLinear(embed_dim, num_classes)
        self.tp = None  # the parallel.tensor.TensorParallel of a tensor-parallel model

    def forward(self, images: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        B = images.shape[0]
        D = self.config["embed_dim"]
        x = self.qact_input(images, update_stats=train)
        x = self.qact_embed(self.patch_embed(x), update_stats=train)

        # the cls token joins the patch tokens at their scale. SIM.round
        # (straight through under SIM) lets the token train, as the
        # reference's raw float concat does; rounding it keeps SIM equal
        # to the engine, which needs an integer carrier
        cls_q = SIM.round(div(self.cls_token, x.scale.detach())).expand(B, 1, D)
        x = x.replace(q=torch.cat([cls_q, x.q], dim=1))

        # the pos-embed at its own scale, merged by the dual-scale requant
        pos = self.qact_pos(self.pos_embed, update_stats=train)
        x = self.qact1(x, identity=pos.replace(q=pos.q.expand(x.q.shape)), update_stats=train)

        # sequence parallelism: each rank holds its tokens between the
        # blocks (JAX's act_constraint sits at these boundaries)
        seq = None if self.tp is None else self.tp.seq_axis
        if seq is not None:
            x = x.replace(q=seq.scatter_tokens(x.q))
        for blk in self.blocks:
            x = remat_block(blk, x, train, generator) if self.remat else blk(x, train, generator)
        if seq is not None:
            x = x.replace(q=seq.gather_tokens(x.q, grad_sum=False))  # the rest runs whole on every rank

        x = self.norm(x)
        x = self.qact2(x.replace(q=x.q[:, 0]), update_stats=train)  # CLS token
        return head_logits(self.head, x)


deit_tiny_patch16_224 = partial(vit_config, embed_dim=192, depth=12, num_heads=3)
deit_small_patch16_224 = partial(vit_config, embed_dim=384, depth=12, num_heads=6)
deit_base_patch16_224 = partial(vit_config, embed_dim=768, depth=12, num_heads=12)
vit_base_patch16_224 = partial(vit_config, embed_dim=768, depth=12, num_heads=12)
vit_large_patch16_224 = partial(vit_config, embed_dim=1024, depth=24, num_heads=16)
