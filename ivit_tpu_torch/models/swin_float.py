"""Float (FP32) Swin Transformer on the QAT Swin's weights.

Counterpart of ``ivit_tpu/models/swin_float.py``: the Swin family's FP32
column. Modules keep the flax model's flat names
(``layers_{i}_blocks_{j}_attn_qkv``,
``layers_{i}_blocks_{j}_attn_relative_position_bias_table``,
``layers_{i}_downsample_reduction``, ...), so
``nn.flax_state.load_flax_variables`` carries a flax float Swin across
and ``swin_quant_params_to_float`` re-keys a QAT tree onto them. The
window geometry, relative-position index and shifted-window mask are
the QAT Swin's (``models/swin.py``); LayerNorm takes torch's eps, 1e-5.
The final mean over tokens is ``models/swin.token_mean``, the value
JAX's compiled ``jnp.mean`` gives. The drop rates are taken and, as in
JAX, never applied.
"""

from __future__ import annotations

from functools import partial

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.quant import trunc_normal_
from .swin import _mask_on, gather_bias, stage_geometry, swin_config, token_mean, window_partition, window_reverse
from .vit_float import Dense, LayerNorm, gather_heads, head_logits, patchify


class FloatSwinTransformer(nn.Module):
    """The float Swin on NHWC images; returns float32 logits. ``train``
    and ``generator`` are taken so the trainer's steps drive it, and
    change nothing."""

    def __init__(
        self,
        img_size: int = 224,
        patch_size: int = 4,
        in_chans: int = 3,
        num_classes: int = 1000,
        embed_dim: int = 96,
        depths=(2, 2, 6, 2),
        num_heads=(3, 6, 12, 24),
        window_size: int = 7,
        mlp_ratio: float = 4.0,
        qkv_bias: bool = True,
        drop_rate: float = 0.0,
        attn_drop_rate: float = 0.0,
        drop_path_rate: float = 0.0,
        ape: bool = False,
    ):
        super().__init__()
        self.config = swin_config(img_size, patch_size, num_classes, embed_dim, depths, num_heads, window_size,
                                  mlp_ratio)
        self.ape = ape
        D = embed_dim
        grid = img_size // patch_size
        self.patch_embed_proj = Dense(patch_size * patch_size * in_chans, D)
        self.patch_norm = LayerNorm(D, 1e-5)
        if ape:
            self.absolute_pos_embed = nn.Parameter(trunc_normal_(torch.empty(1, grid * grid, D), 0.02))
        # flax's flat names; each stage a list of its blocks' layers, then
        # its patch merging (None after the last stage)
        self.stages = []
        for i, depth in enumerate(depths):
            dim = D * 2**i
            blocks = []
            for j in range(depth):
                pre = f"layers_{i}_blocks_{j}"
                ws = stage_geometry(self.config, i, j)[1]
                table = nn.Parameter(trunc_normal_(torch.empty((2 * ws - 1) ** 2, num_heads[i]), 0.02))
                self.register_parameter(f"{pre}_attn_relative_position_bias_table", table)
                layers = dict(norm1=LayerNorm(dim, 1e-5), attn_qkv=Dense(dim, 3 * dim, qkv_bias),
                              attn_proj=Dense(dim, dim), norm2=LayerNorm(dim, 1e-5),
                              mlp_fc1=Dense(dim, int(dim * mlp_ratio)), mlp_fc2=Dense(int(dim * mlp_ratio), dim))
                for name, layer in layers.items():
                    self.add_module(f"{pre}_{name}", layer)
                blocks.append(layers)
            merge = None
            if i < len(depths) - 1:
                merge = dict(norm=LayerNorm(4 * dim, 1e-5), reduction=Dense(4 * dim, 2 * dim, use_bias=False))
                for name, layer in merge.items():
                    self.add_module(f"layers_{i}_downsample_{name}", layer)
            self.stages.append((blocks, merge))
        nf = D * 2 ** (len(depths) - 1)
        self.norm = LayerNorm(nf, 1e-5)
        self.head = Dense(nf, num_classes)
        self.attn_heads = {f"layers_{i}_blocks_{j}_attn_qkv": num_heads[i]  # parallel.mesh.tp_groups
                           for i, depth in enumerate(depths) for j in range(depth)}
        self.tp = None  # the parallel.tensor.TensorParallel of a tensor-parallel model

    def forward(self, images: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        cfg = self.config
        B = images.shape[0]
        x = self.patch_norm(self.patch_embed_proj(patchify(images.to(torch.float32), cfg["patch_size"])))
        if self.ape:
            x = x + self.absolute_pos_embed
        for i, (blocks, merge) in enumerate(self.stages):
            dim = cfg["embed_dim"] * 2**i
            H = cfg["num_heads"][i]
            hd = dim // H
            for j, blk in enumerate(blocks):
                res, ws, shift = stage_geometry(cfg, i, j)
                g = blk["norm1"](x).reshape(B, res, res, dim)
                if shift:
                    g = torch.roll(g, (-shift, -shift), dims=(1, 2))
                xw = window_partition(g, ws)  # (B·nW, N, dim)
                Bw, N, _ = xw.shape
                qkv = blk["attn_qkv"](xw)
                Hl = qkv.shape[-1] // (3 * hd)  # this rank's heads
                h0 = 0 if Hl == H else blk["attn_qkv"].split.axis.rank * Hl
                qkv = qkv.reshape(Bw, N, 3, Hl, hd).permute(2, 0, 3, 1, 4)
                attn = torch.matmul(qkv[0], qkv[1].transpose(-1, -2)) * hd**-0.5
                # by attribute, so that torch.func.functional_call's parameters take its place
                table = getattr(self, f"layers_{i}_blocks_{j}_attn_relative_position_bias_table")
                attn = attn + gather_bias(table, ws)[None, h0:h0 + Hl]
                mask = _mask_on(res, res, ws, shift, x.device)
                if mask is not None:
                    nW = mask.shape[0]
                    attn = (attn.reshape(Bw // nW, nW, Hl, N, N) + mask[None, :, None]).reshape(Bw, Hl, N, N)
                ctx = torch.matmul(torch.softmax(attn, -1), qkv[2]).transpose(1, 2).reshape(Bw, N, Hl * hd)
                g = window_reverse(blk["attn_proj"](gather_heads(blk["attn_qkv"], ctx)), ws, res, res)
                if shift:
                    g = torch.roll(g, (shift, shift), dims=(1, 2))
                x = x + g.reshape(B, res * res, dim)
                y = F.gelu(blk["mlp_fc1"](blk["norm2"](x)), approximate="none")
                x = x + blk["mlp_fc2"](y)
            if merge is not None:
                res = cfg["img_size"] // cfg["patch_size"] // 2**i
                g = x.reshape(B, res, res, dim)
                x = torch.cat([g[:, 0::2, 0::2], g[:, 1::2, 0::2], g[:, 0::2, 1::2], g[:, 1::2, 1::2]], -1)
                x = merge["reduction"](merge["norm"](x.reshape(B, -1, 4 * dim)))
        return head_logits(self.head, token_mean(self.norm(x)))


def swin_quant_params_to_float(params: dict) -> dict:
    """Re-key a QAT SwinTransformer's parameter tree (flax's nested
    layout) onto the float model's flat names."""
    out = {
        "patch_embed_proj": params["patch_embed"]["proj"],
        "patch_norm": params["patch_norm"],
        "norm": params["norm"],
        "head": params["head"],
    }
    if "absolute_pos_embed" in params:
        out["absolute_pos_embed"] = params["absolute_pos_embed"]
    for name, sub in params.items():
        if name.startswith("layers_") and "_blocks_" in name:
            out[f"{name}_norm1"] = sub["norm1"]
            out[f"{name}_norm2"] = sub["norm2"]
            out[f"{name}_attn_qkv"] = sub["attn"]["qkv"]
            out[f"{name}_attn_proj"] = sub["attn"]["proj"]
            out[f"{name}_attn_relative_position_bias_table"] = sub["attn"]["relative_position_bias_table"]
            out[f"{name}_mlp_fc1"] = sub["mlp"]["fc1"]
            out[f"{name}_mlp_fc2"] = sub["mlp"]["fc2"]
        elif name.endswith("_downsample"):
            out[f"{name}_norm"] = sub["norm"]
            out[f"{name}_reduction"] = sub["reduction"]
    return out


swin_tiny_fp32 = partial(FloatSwinTransformer, embed_dim=96, depths=(2, 2, 6, 2), num_heads=(3, 6, 12, 24))
swin_small_fp32 = partial(FloatSwinTransformer, embed_dim=96, depths=(2, 2, 18, 2), num_heads=(3, 6, 12, 24))
swin_base_fp32 = partial(FloatSwinTransformer, embed_dim=128, depths=(2, 2, 18, 2), num_heads=(4, 8, 16, 32))
