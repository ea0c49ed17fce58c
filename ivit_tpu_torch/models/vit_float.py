"""Float (FP32) Vision Transformer on the QAT model's weights.

Counterpart of ``ivit_tpu/models/vit_float.py``: the FP32 column of the
accuracy table, one imported checkpoint serving both columns
(``create_model("deit_small_fp32")`` beside ``"deit_small"``). Its
modules keep the flax model's flat names (``patch_embed_proj``,
``blocks_0_attn_qkv`` with a ``kernel`` (in, out) and a ``bias``,
``blocks_0_norm1`` with a ``scale`` and a ``bias``), so
``nn.flax_state.load_flax_variables`` carries a flax float model's
variables across, and ``quant_params_to_float`` re-keys a QAT tree onto
them.

The forward is flax's: the patch as space-to-depth then a dense layer,
LayerNorm (eps 1e-6) as the mean of squared deviations,
``softmax(q·kᵀ·hd^-0.5)``, the erf GELU. It differs from JAX's in the
last float32 places (summation orders, ``rsqrt``, ``erf`` and ``exp``).
JAX declares the drop rates and never applies them; so does this model.
"""

from __future__ import annotations

from functools import partial

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.quant import LinearSplit, trunc_normal_


class Dense(nn.Module):
    """flax's ``nn.Dense``: ``x @ kernel + bias``, the kernel (in, out).
    ``split`` (set by ``parallel.tensor``, a ``nn.quant.LinearSplit``)
    makes it column-parallel (its input's gradient summed over the model
    group) or row-parallel (the partial products summed, then the bias
    added once)."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True):
        super().__init__()
        self.kernel = nn.Parameter(trunc_normal_(torch.empty(in_features, features), 0.02))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None
        self.split: LinearSplit | None = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        split = self.split
        if split is None:
            y = torch.matmul(x, self.kernel)
        elif split.rows:
            y = split.axis.reduce(torch.matmul(x, self.kernel))
        else:
            y = torch.matmul(split.axis.copy(x), self.kernel)
        return y if self.bias is None else y + self.bias


def gather_heads(qkv: Dense, ctx: torch.Tensor) -> torch.Tensor:
    """Attention's (..., local heads · hd) output, every head's where
    ``qkv`` is split by heads (``parallel.tensor``)."""
    return ctx if qkv.split is None else qkv.split.axis.gather_last(ctx)


class LayerNorm(nn.Module):
    """flax's ``nn.LayerNorm(use_fast_variance=False)``: the variance is
    the mean of squared deviations, and ``(x − μ)·(rsqrt(var + eps)·γ) + β``."""

    def __init__(self, features: int, eps: float):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mu = x.mean(-1, keepdim=True)
        y = x - mu
        var = (y * y).mean(-1, keepdim=True)
        return y * (torch.rsqrt(var + self.eps) * self.scale) + self.bias


def head_logits(head: Dense, x: torch.Tensor) -> torch.Tensor:
    """The logits of ``head`` on ``x``, gathered over the model axis where
    it is split by classes (``parallel.tensor``)."""
    logits = head(x)
    return logits if head.split is None else head.split.axis.gather_last(logits)


def patchify(images: torch.Tensor, p: int) -> torch.Tensor:
    """NHWC images → (B, patches, p·p·C), each patch's rows in (ph, pw, c)
    order."""
    B, H, W, C = images.shape
    x = images.reshape(B, H // p, p, W // p, p, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, (H // p) * (W // p), p * p * C)


class FloatVisionTransformer(nn.Module):
    """The float ViT on NHWC images; returns float32 logits. ``train``
    and ``generator`` are taken so the trainer's steps drive it, and
    change nothing."""

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
    ):
        super().__init__()
        D = embed_dim
        self.patch_size, self.embed_dim, self.depth, self.num_heads = patch_size, D, depth, num_heads
        gh = img_size // patch_size
        hidden = int(D * mlp_ratio)
        self.patch_embed_proj = Dense(patch_size * patch_size * in_chans, D)
        self.cls_token = nn.Parameter(trunc_normal_(torch.empty(1, 1, D), 0.02))
        self.pos_embed = nn.Parameter(trunc_normal_(torch.empty(1, gh * gh + 1, D), 0.02))
        # flax's flat names: blocks_{i}_norm1, blocks_{i}_attn_qkv, ...
        self.blocks = []
        for i in range(depth):
            layers = dict(norm1=LayerNorm(D, 1e-6), attn_qkv=Dense(D, 3 * D, qkv_bias), attn_proj=Dense(D, D),
                          norm2=LayerNorm(D, 1e-6), mlp_fc1=Dense(D, hidden), mlp_fc2=Dense(hidden, D))
            for name, layer in layers.items():
                self.add_module(f"blocks_{i}_{name}", layer)
            self.blocks.append(layers)
        self.norm = LayerNorm(D, 1e-6)
        self.head = Dense(D, num_classes)
        self.attn_heads = {f"blocks_{i}_attn_qkv": num_heads for i in range(depth)}  # parallel.mesh.tp_groups
        self.tp = None  # the parallel.tensor.TensorParallel of a tensor-parallel model

    def forward(self, images: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        B = images.shape[0]
        D, H = self.embed_dim, self.num_heads
        hd = D // H
        x = self.patch_embed_proj(patchify(images.to(torch.float32), self.patch_size))
        x = torch.cat([self.cls_token.expand(B, 1, D), x], 1) + self.pos_embed
        for blk in self.blocks:
            qkv = blk["attn_qkv"](blk["norm1"](x))
            Hl = qkv.shape[-1] // (3 * hd)  # this rank's heads
            qkv = qkv.reshape(B, -1, 3, Hl, hd).permute(2, 0, 3, 1, 4)
            attn = torch.softmax(torch.matmul(qkv[0], qkv[1].transpose(-1, -2)) * hd**-0.5, -1)
            ctx = torch.matmul(attn, qkv[2]).transpose(1, 2).reshape(B, -1, Hl * hd)
            x = x + blk["attn_proj"](gather_heads(blk["attn_qkv"], ctx))
            y = F.gelu(blk["mlp_fc1"](blk["norm2"](x)), approximate="none")
            x = x + blk["mlp_fc2"](y)
        return head_logits(self.head, self.norm(x)[:, 0])


def quant_params_to_float(params: dict) -> dict:
    """Re-key a QAT VisionTransformer's parameter tree (flax's nested
    layout) onto the float model's flat names: the same arrays."""
    out = {
        "cls_token": params["cls_token"],
        "pos_embed": params["pos_embed"],
        "patch_embed_proj": params["patch_embed"]["proj"],
        "norm": params["norm"],
        "head": params["head"],
    }
    i = 0
    while f"blocks_{i}" in params:
        b = params[f"blocks_{i}"]
        out[f"blocks_{i}_norm1"] = b["norm1"]
        out[f"blocks_{i}_attn_qkv"] = b["attn"]["qkv"]
        out[f"blocks_{i}_attn_proj"] = b["attn"]["proj"]
        out[f"blocks_{i}_norm2"] = b["norm2"]
        out[f"blocks_{i}_mlp_fc1"] = b["mlp"]["fc1"]
        out[f"blocks_{i}_mlp_fc2"] = b["mlp"]["fc2"]
        i += 1
    return out


deit_tiny_fp32 = partial(FloatVisionTransformer, embed_dim=192, depth=12, num_heads=3)
deit_small_fp32 = partial(FloatVisionTransformer, embed_dim=384, depth=12, num_heads=6)
deit_base_fp32 = partial(FloatVisionTransformer, embed_dim=768, depth=12, num_heads=12)
vit_base_fp32 = partial(FloatVisionTransformer, embed_dim=768, depth=12, num_heads=12)
vit_large_fp32 = partial(FloatVisionTransformer, embed_dim=1024, depth=24, num_heads=16)
