"""Pretrained checkpoint importers: torch state dicts and augreg ``.npz``.

Counterpart of ``ivit_tpu/models/import_torch.py``, in numpy as JAX's
is, so its trees equal JAX's leaf for leaf. A public DeiT/ViT or Swin
checkpoint maps onto flax's nested parameter tree, the layout
``nn.flax_state`` carries into a port model:

* a torch linear ``weight`` (out, in) becomes a ``kernel`` (in, out);
* the patch-embed conv ``weight`` (D, C, ph, pw) becomes the
  space-to-depth kernel (ph·pw·C, D), rows in (ph, pw, c) order, as
  ``QuantPatchEmbed`` flattens a patch;
* a LayerNorm ``weight``/``bias`` becomes ``scale``/``bias``.

``load_pretrained`` merges with torch's ``strict=False`` semantics: a
key missing from the checkpoint, or one whose shape differs, keeps the
model's initial value and is logged. A position embedding on another
grid is resized bicubically first (torch's kernel, A = −0.75).
"""

from __future__ import annotations

import logging
import math
from typing import Dict

import numpy as np
import torch

from ..nn.flax_state import flax_variables, load_flax_variables

NO_DOWNLOAD = ("--pretrained auto downloads the published checkpoint, which ivit_tpu_torch does not do "
               "(ROADMAP.md §1 item 9): download it on a networked machine and pass --pretrained <local path>")

# torch's bicubic uses the Keys cubic-convolution kernel with A = -0.75
# (aten UpSample.h cubic_convolution1/2)
_CUBIC_A = -0.75


def _cubic_weights(t: np.ndarray) -> np.ndarray:
    """The 4 tap weights torch computes per fractional offset ``t``
    (aten get_cubic_upsample_coefficients): taps at offsets
    (-1, 0, +1, +2) around ``floor(src)``."""
    A = np.float32(_CUBIC_A)
    t = t.astype(np.float32)

    def conv1(x):  # |x| <= 1
        return ((A + 2) * x - (A + 3)) * x * x + 1

    def conv2(x):  # 1 < |x| < 2
        return ((A * x - 5 * A) * x + 8 * A) * x - 4 * A

    return np.stack([conv2(t + 1), conv1(t), conv1(1 - t), conv2(2 - t)], axis=0).astype(np.float32)


def _cubic_taps(n_in: int, n_out: int):
    """Source tap indices (4, n_out) int and weights (4, n_out) f32 for
    one axis of ``F.interpolate(mode='bicubic', align_corners=False)``:
    src = (dst + 0.5)·(in/out) − 0.5, taps clamped to the border."""
    scale = np.float32(n_in) / np.float32(n_out)
    dst = np.arange(n_out, dtype=np.float32)
    src = scale * (dst + np.float32(0.5)) - np.float32(0.5)
    base = np.floor(src).astype(np.int64)
    t = src - base
    w = _cubic_weights(t)
    idx = np.clip(base[None, :] + np.arange(-1, 3, dtype=np.int64)[:, None], 0, n_in - 1)
    return idx, w


def bicubic_resize_nchw(g: np.ndarray, h_new: int, w_new: int) -> np.ndarray:
    """``F.interpolate(x, (h_new, w_new), mode='bicubic',
    align_corners=False)`` in numpy, float32, in the separable order of
    torch's CPU kernel (horizontal cubic, then vertical cubic of the 4
    horizontal results). It agrees with torch to float32 rounding (torch
    orders its multiply-adds otherwise), far below the int8 step the
    resized position embedding feeds."""
    g = np.asarray(g, np.float32)
    ix, wx = _cubic_taps(g.shape[-1], w_new)
    iy, wy = _cubic_taps(g.shape[-2], h_new)
    cols = [g[..., ix[k]] * wx[k] for k in range(4)]
    h = ((cols[0] + cols[1]) + cols[2]) + cols[3]
    rows = [h[..., iy[k], :] * wy[k][:, None] for k in range(4)]
    return (((rows[0] + rows[1]) + rows[2]) + rows[3]).astype(np.float32)


def resize_pos_embed(posemb: np.ndarray, ntok_new: int, num_tokens: int = 1) -> np.ndarray:
    """Bicubic grid resize of a (1, N, D) position embedding to
    ``ntok_new`` tokens; the first ``num_tokens`` (the class token) stay."""
    posemb_tok = posemb[:, :num_tokens]
    grid = posemb[0, num_tokens:]
    gs_old = int(round(math.sqrt(grid.shape[0])))
    gs_new = int(round(math.sqrt(ntok_new - num_tokens)))
    if gs_old * gs_old != grid.shape[0]:
        raise ValueError(f"pos embed grid {grid.shape[0]} not square")
    if gs_new * gs_new != ntok_new - num_tokens:
        raise ValueError(f"target token count {ntok_new} not square")
    g = np.ascontiguousarray(grid.reshape(1, gs_old, gs_old, -1).transpose(0, 3, 1, 2), dtype=np.float32)
    g = bicubic_resize_nchw(g, gs_new, gs_new)
    g = g.transpose(0, 2, 3, 1).reshape(1, gs_new * gs_new, -1)
    return np.concatenate([posemb_tok, g.astype(np.float32)], axis=1).astype(np.float32)


def _to_numpy(t):
    try:
        return t.detach().cpu().numpy()
    except AttributeError:
        return np.asarray(t)


def _putter(params: dict):
    """A function that stores a float32 copy of a value at a nested path
    of ``params``."""

    def put(path, value):
        node = params
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = np.asarray(value, np.float32)

    return put


def torch_vit_to_params(state_dict: Dict[str, "np.ndarray"]) -> dict:
    """Map a (De)iT torch state dict to the VisionTransformer's tree."""
    sd = {k: _to_numpy(v) for k, v in state_dict.items()}
    params: dict = {}
    put = _putter(params)

    if "cls_token" in sd:
        put(("cls_token",), sd["cls_token"])
    if "pos_embed" in sd:
        put(("pos_embed",), sd["pos_embed"])

    if "patch_embed.proj.weight" in sd:
        w = sd["patch_embed.proj.weight"]  # (D, C, ph, pw)
        put(("patch_embed", "proj", "kernel"), w.transpose(2, 3, 1, 0).reshape(-1, w.shape[0]))
        put(("patch_embed", "proj", "bias"), sd["patch_embed.proj.bias"])

    depth = 1 + max((int(k.split(".")[1]) for k in sd if k.startswith("blocks.")), default=-1)
    for i in range(depth):
        src, dst = f"blocks.{i}", f"blocks_{i}"
        for norm in ("norm1", "norm2"):
            put((dst, norm, "scale"), sd[f"{src}.{norm}.weight"])
            put((dst, norm, "bias"), sd[f"{src}.{norm}.bias"])
        put((dst, "attn", "qkv", "kernel"), sd[f"{src}.attn.qkv.weight"].T)
        if f"{src}.attn.qkv.bias" in sd:
            put((dst, "attn", "qkv", "bias"), sd[f"{src}.attn.qkv.bias"])
        put((dst, "attn", "proj", "kernel"), sd[f"{src}.attn.proj.weight"].T)
        put((dst, "attn", "proj", "bias"), sd[f"{src}.attn.proj.bias"])
        put((dst, "mlp", "fc1", "kernel"), sd[f"{src}.mlp.fc1.weight"].T)
        put((dst, "mlp", "fc1", "bias"), sd[f"{src}.mlp.fc1.bias"])
        put((dst, "mlp", "fc2", "kernel"), sd[f"{src}.mlp.fc2.weight"].T)
        put((dst, "mlp", "fc2", "bias"), sd[f"{src}.mlp.fc2.bias"])

    if "norm.weight" in sd:
        put(("norm", "scale"), sd["norm.weight"])
        put(("norm", "bias"), sd["norm.bias"])
    if "head.weight" in sd:
        put(("head", "kernel"), sd["head.weight"].T)
        put(("head", "bias"), sd["head.bias"])
    return params


def npz_vit_to_params(npz, depth: int) -> dict:
    """Map an augreg flax ``.npz`` ViT checkpoint (``depth`` blocks) to
    the VisionTransformer's tree."""
    g = dict(npz)
    params: dict = {}
    put = _putter(params)

    put(("cls_token",), g["cls"])
    put(("pos_embed",), g["Transformer/posembed_input/pos_embedding"])
    w = g["embedding/kernel"]  # (ph, pw, C, D), already HWIO
    put(("patch_embed", "proj", "kernel"), w.reshape(-1, w.shape[-1]))
    put(("patch_embed", "proj", "bias"), g["embedding/bias"])

    for i in range(depth):
        src, dst = f"Transformer/encoderblock_{i}", f"blocks_{i}"
        put((dst, "norm1", "scale"), g[f"{src}/LayerNorm_0/scale"])
        put((dst, "norm1", "bias"), g[f"{src}/LayerNorm_0/bias"])
        put((dst, "norm2", "scale"), g[f"{src}/LayerNorm_2/scale"])
        put((dst, "norm2", "bias"), g[f"{src}/LayerNorm_2/bias"])

        att = f"{src}/MultiHeadDotProductAttention_1"
        D = g[f"{att}/query/kernel"].shape[0]
        qkv_k = np.concatenate([g[f"{att}/{n}/kernel"].reshape(D, D) for n in ("query", "key", "value")], axis=1)
        qkv_b = np.concatenate([g[f"{att}/{n}/bias"].reshape(D) for n in ("query", "key", "value")])
        put((dst, "attn", "qkv", "kernel"), qkv_k)
        put((dst, "attn", "qkv", "bias"), qkv_b)
        put((dst, "attn", "proj", "kernel"), g[f"{att}/out/kernel"].reshape(D, D))
        put((dst, "attn", "proj", "bias"), g[f"{att}/out/bias"])

        mlp = f"{src}/MlpBlock_3"
        put((dst, "mlp", "fc1", "kernel"), g[f"{mlp}/Dense_0/kernel"])
        put((dst, "mlp", "fc1", "bias"), g[f"{mlp}/Dense_0/bias"])
        put((dst, "mlp", "fc2", "kernel"), g[f"{mlp}/Dense_1/kernel"])
        put((dst, "mlp", "fc2", "bias"), g[f"{mlp}/Dense_1/bias"])

    put(("norm", "scale"), g["Transformer/encoder_norm/scale"])
    put(("norm", "bias"), g["Transformer/encoder_norm/bias"])
    if "head/kernel" in g:
        put(("head", "kernel"), g["head/kernel"])
        put(("head", "bias"), g["head/bias"])
    return params


def merge_params(init_params: dict, loaded: dict, prefix=""):
    """strict=False merge: loaded values replace the initial ones where
    the shapes match; every other leaf keeps its initial value, logged."""
    out = {}
    for k, v in init_params.items():
        if k in loaded:
            if isinstance(v, dict):
                out[k] = merge_params(v, loaded[k], f"{prefix}{k}/")
            elif tuple(loaded[k].shape) == tuple(np.shape(v)):
                out[k] = loaded[k]
            else:
                logging.warning("shape mismatch at %s%s: ckpt %s vs model %s — keeping init",
                                prefix, k, loaded[k].shape, np.shape(v))
                out[k] = v
        else:
            logging.warning("missing in checkpoint: %s%s", prefix, k)
            out[k] = v
    return out


def load_pretrained(path: str, model_name: str, model: torch.nn.Module) -> torch.nn.Module:
    """Load a torch ``.pth``/``.pth.tar`` (a state dict, or one under
    ``"model"``) or an augreg ``.npz`` into the QAT ``model``, in place,
    merged as ``merge_params`` merges into the model's parameters (its
    ``QuantAct`` ranges stay). ``model_name`` picks the Swin importer for
    a ``swin*`` name. Returns ``model``.

    ``path="auto"``, which makes JAX fetch the reference's published
    checkpoint, exits here: this package downloads nothing."""
    if path == "auto":
        raise SystemExit(NO_DOWNLOAD)
    variables = flax_variables(model)
    init_params = variables["params"]
    if path.endswith(".npz"):
        depth = 1 + max(int(k.split("_")[1]) for k in init_params if k.startswith("blocks_"))
        with np.load(path) as npz:
            loaded = npz_vit_to_params(npz, depth)
    else:
        # the reference's .pth.tar pickles more than tensors (an
        # argparse.Namespace), which weights_only=True refuses
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
        sd = ckpt.get("model", ckpt) if isinstance(ckpt, dict) else ckpt
        if model_name.startswith("swin"):
            from .import_swin import torch_swin_to_params

            loaded = torch_swin_to_params(sd)
        else:
            loaded = torch_vit_to_params(sd)
    if "pos_embed" in loaded and "pos_embed" in init_params:
        tgt = tuple(np.shape(init_params["pos_embed"]))
        if tuple(loaded["pos_embed"].shape) != tgt:
            logging.info("resizing pos_embed %s -> %s (bicubic)", loaded["pos_embed"].shape, tgt)
            loaded["pos_embed"] = resize_pos_embed(loaded["pos_embed"], tgt[1])
    variables["params"] = merge_params(init_params, loaded)
    return load_flax_variables(model, variables)
