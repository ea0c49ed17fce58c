"""Swin torch checkpoint → the SwinTransformer's parameter tree.

Counterpart of ``ivit_tpu/models/import_swin.py`` (numpy, leaf for leaf
JAX's): maps the official Swin checkpoints onto flax's nested tree. The
patch-merging gather order [x00, x10, x01, x11] is the reference's, so
the merge's norm and reduction weights map directly; buffers the
checkpoints also hold (``relative_position_index``, ``attn_mask``) are
not parameters and are left out.
"""

from __future__ import annotations

from .import_torch import _putter, _to_numpy


def torch_swin_to_params(state_dict) -> dict:
    sd = {k: _to_numpy(v) for k, v in state_dict.items()}
    params: dict = {}
    put = _putter(params)

    if "patch_embed.proj.weight" in sd:
        w = sd["patch_embed.proj.weight"]  # (D, C, ph, pw)
        put(("patch_embed", "proj", "kernel"), w.transpose(2, 3, 1, 0).reshape(-1, w.shape[0]))
        put(("patch_embed", "proj", "bias"), sd["patch_embed.proj.bias"])
    if "patch_embed.norm.weight" in sd:
        put(("patch_norm", "scale"), sd["patch_embed.norm.weight"])
        put(("patch_norm", "bias"), sd["patch_embed.norm.bias"])
    if "absolute_pos_embed" in sd:
        put(("absolute_pos_embed",), sd["absolute_pos_embed"])

    layers = sorted({int(k.split(".")[1]) for k in sd if k.startswith("layers.")})
    for i in layers:
        blocks = sorted({int(k.split(".")[3]) for k in sd if k.startswith(f"layers.{i}.blocks.")})
        for j in blocks:
            src, dst = f"layers.{i}.blocks.{j}", f"layers_{i}_blocks_{j}"
            for norm in ("norm1", "norm2"):
                put((dst, norm, "scale"), sd[f"{src}.{norm}.weight"])
                put((dst, norm, "bias"), sd[f"{src}.{norm}.bias"])
            put((dst, "attn", "relative_position_bias_table"), sd[f"{src}.attn.relative_position_bias_table"])
            put((dst, "attn", "qkv", "kernel"), sd[f"{src}.attn.qkv.weight"].T)
            if f"{src}.attn.qkv.bias" in sd:
                put((dst, "attn", "qkv", "bias"), sd[f"{src}.attn.qkv.bias"])
            put((dst, "attn", "proj", "kernel"), sd[f"{src}.attn.proj.weight"].T)
            put((dst, "attn", "proj", "bias"), sd[f"{src}.attn.proj.bias"])
            put((dst, "mlp", "fc1", "kernel"), sd[f"{src}.mlp.fc1.weight"].T)
            put((dst, "mlp", "fc1", "bias"), sd[f"{src}.mlp.fc1.bias"])
            put((dst, "mlp", "fc2", "kernel"), sd[f"{src}.mlp.fc2.weight"].T)
            put((dst, "mlp", "fc2", "bias"), sd[f"{src}.mlp.fc2.bias"])
        if f"layers.{i}.downsample.reduction.weight" in sd:
            dstd = f"layers_{i}_downsample"
            put((dstd, "norm", "scale"), sd[f"layers.{i}.downsample.norm.weight"])
            put((dstd, "norm", "bias"), sd[f"layers.{i}.downsample.norm.bias"])
            put((dstd, "reduction", "kernel"), sd[f"layers.{i}.downsample.reduction.weight"].T)

    if "norm.weight" in sd:
        put(("norm", "scale"), sd["norm.weight"])
        put(("norm", "bias"), sd["norm.bias"])
    if "head.weight" in sd:
        put(("head", "kernel"), sd["head.weight"].T)
        put(("head", "bias"), sd["head.bias"])
    return params
