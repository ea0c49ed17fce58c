"""Checkpoint layouts built from other data, for the port's tests on the
CPU and on the card (``tests/test_torch_ingest.py``,
``tests/test_torch_import.py``, ``tests/test_torch_cuda.py``).

A reference QAT checkpoint keeps each layer's integers and scales as the
``weight_integer`` / ``bias_integer`` / ``*_scaling_factor`` buffers the
ingester reads; ``vit_state`` and its helpers write an artifact's own
into that layout. ``augreg_npz`` rewrites a float ViT state dict in the
augreg ``.npz`` layout. All are numpy arrays; the module imports numpy
only, neither JAX nor torch.
"""

import numpy as np


def act(sd, name, scale):
    sd[f"{name}.act_scaling_factor"] = np.array([scale], np.float32)


def linear(sd, prefix, layer, s_in):
    """A QuantLinear's buffers: (out, in) float-held integer weights, the
    integer bias and the per-channel weight scale out_scale / s_in."""
    sd[f"{prefix}.weight_integer"] = layer["w"].T.astype(np.float32)
    if "b" in layer:
        sd[f"{prefix}.bias_integer"] = layer["b"].astype(np.float32)
    sd[f"{prefix}.fc_scaling_factor"] = (layer["out_scale"] / np.float32(s_in)).astype(np.float32)


def norm(sd, prefix, n):
    sd[f"{prefix}.bias_integer"] = n["bias_int"]
    sd[f"{prefix}.norm_scaling_factor"] = n["out_scale"]


def patch_embed(sd, a):
    p, D = a["config"]["patch_size"], a["config"]["embed_dim"]
    pe = a["patch_embed"]
    act(sd, "qact_input", a["input_scale"])
    sd["patch_embed.proj.weight_integer"] = pe["w"].reshape(p, p, 3, D).transpose(3, 2, 0, 1).astype(np.float32)
    sd["patch_embed.proj.bias_integer"] = pe["b"].astype(np.float32)
    sd["patch_embed.proj.conv_scaling_factor"] = (pe["out_scale"] / np.float32(a["input_scale"])).astype(np.float32)


def mlp(sd, b, blk):
    norm(sd, f"{b}.norm2", blk["norm2"])
    act(sd, f"{b}.qact3", blk["s_qact3"])
    linear(sd, f"{b}.mlp.fc1", blk["fc1"], blk["s_qact3"])
    act(sd, f"{b}.mlp.qact_gelu", blk["s_gelu_in"])
    act(sd, f"{b}.mlp.qact1", blk["s_gelu_out"])
    linear(sd, f"{b}.mlp.fc2", blk["fc2"], blk["s_gelu_out"])
    act(sd, f"{b}.mlp.qact2", blk["s_mlp_out"])
    act(sd, f"{b}.qact4", blk["s_res2"])


def vit_state(a):
    """A reference ViT/DeiT QAT state dict holding the integers and scales
    of ViT artifact ``a``."""
    sd = {}
    patch_embed(sd, a)
    act(sd, "patch_embed.qact", a["embed_scale"])
    sd["cls_token"] = (a["cls_q"] * a["embed_scale"]).astype(np.float32)
    act(sd, "qact_pos", a["pos_scale"])
    sd["pos_embed"] = (a["pos_q"] * a["pos_scale"]).astype(np.float32)
    act(sd, "qact1", a["tokens_scale"])
    for i, blk in enumerate(a["blocks"]):
        b = f"blocks.{i}"
        norm(sd, f"{b}.norm1", blk["norm1"])
        act(sd, f"{b}.qact1", blk["s_qact1"])
        linear(sd, f"{b}.attn.qkv", blk["qkv"], blk["s_qact1"])
        act(sd, f"{b}.attn.qact1", blk["s_attn_qact1"])
        act(sd, f"{b}.attn.qact_attn1", blk["s_attn_sm_in"])
        act(sd, f"{b}.attn.qact2", blk["s_attn_out"])
        linear(sd, f"{b}.attn.proj", blk["proj"], blk["s_attn_out"])
        act(sd, f"{b}.attn.qact3", blk["s_attn_proj"])
        act(sd, f"{b}.qact2", blk["s_res1"])
        mlp(sd, b, blk)
    norm(sd, "norm", a["norm"])
    act(sd, "qact2", a["head_in_scale"])
    linear(sd, "head", a["head"], a["head_in_scale"])
    return sd


def augreg_npz(sd, heads):
    """A timm-layout ViT state dict ``sd`` (numpy) in the augreg ``.npz``
    layout (as ``tests/test_import.py``'s npz-agreement test builds it)."""
    D = sd["cls_token"].shape[-1]
    hd = D // heads
    depth = 1 + max(int(k.split(".")[1]) for k in sd if k.startswith("blocks."))
    g = {
        "cls": sd["cls_token"],
        "Transformer/posembed_input/pos_embedding": sd["pos_embed"],
        "embedding/kernel": sd["patch_embed.proj.weight"].transpose(2, 3, 1, 0),
        "embedding/bias": sd["patch_embed.proj.bias"],
        "Transformer/encoder_norm/scale": sd["norm.weight"],
        "Transformer/encoder_norm/bias": sd["norm.bias"],
        "head/kernel": sd["head.weight"].T,
        "head/bias": sd["head.bias"],
    }
    for i in range(depth):
        src, b = f"Transformer/encoderblock_{i}", f"blocks.{i}"
        att = f"{src}/MultiHeadDotProductAttention_1"
        w, bias = sd[f"{b}.attn.qkv.weight"], sd[f"{b}.attn.qkv.bias"]
        for j, n in enumerate(("query", "key", "value")):
            g[f"{att}/{n}/kernel"] = w[j * D:(j + 1) * D].T.reshape(D, heads, hd)
            g[f"{att}/{n}/bias"] = bias[j * D:(j + 1) * D].reshape(heads, hd)
        g[f"{att}/out/kernel"] = sd[f"{b}.attn.proj.weight"].T.reshape(heads, hd, D)
        g[f"{att}/out/bias"] = sd[f"{b}.attn.proj.bias"]
        g[f"{src}/LayerNorm_0/scale"], g[f"{src}/LayerNorm_0/bias"] = sd[f"{b}.norm1.weight"], sd[f"{b}.norm1.bias"]
        g[f"{src}/LayerNorm_2/scale"], g[f"{src}/LayerNorm_2/bias"] = sd[f"{b}.norm2.weight"], sd[f"{b}.norm2.bias"]
        g[f"{src}/MlpBlock_3/Dense_0/kernel"] = sd[f"{b}.mlp.fc1.weight"].T
        g[f"{src}/MlpBlock_3/Dense_0/bias"] = sd[f"{b}.mlp.fc1.bias"]
        g[f"{src}/MlpBlock_3/Dense_1/kernel"] = sd[f"{b}.mlp.fc2.weight"].T
        g[f"{src}/MlpBlock_3/Dense_1/bias"] = sd[f"{b}.mlp.fc2.bias"]
    return g
