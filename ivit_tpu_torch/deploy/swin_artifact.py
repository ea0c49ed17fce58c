"""The frozen Swin artifact: its schema, and its carry-over into torch.

The artifact is what ``ivit_tpu/deploy/swin_engine.py:freeze_swin``
returns: a nested dict of numpy arrays plus Python ints for each block's
window geometry and a ``config`` dict. Each block carries its
relative-position bias already gathered to (H, N, N) and requantized to
the softmax input scale (``bias_req``), and a shifted block its
shifted-window mask already divided by that scale (``mask_int``). Every
stage but the last ends in a patch merging whose ``reduction`` has no
bias.

``swin_artifact_to_torch`` moves the arrays onto a device and precomputes
every requantization ratio once, in float32 on the host, in the order the
JAX engine divides them on its device: the qkv requant
(``swin_engine.py:374-376``), ``s_attn/s1`` (``:470-472``), ``s1/sb``
(``:479``), ``s_ctx/so`` (``:548-551``), the proj requant (``:197-200``),
the residuals (``:581-589``, ``:633-640``), the GELU requants
(``:598-625``), the fc2 requant (``:628-631``), the patch merging
(``:655-660``), the patch-norm and token scales (``:674-687``) and the pool
requant (``:704-705``), and the pool's float32 ``1/L``. K7's scalar
arguments ``r1``, ``rb``, ``scale`` and ``r_out`` also come back as Python
floats holding float32 values.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.device import target_device
from ..models.swin import stage_geometry
from ..ops.interp import div
from .artifact import carry_linear, carry_norm, check_schema, host_f32

_CONFIG_KEYS = (
    "img_size", "patch_size", "embed_dim", "depths", "num_heads",
    "window_size", "mlp_ratio", "num_classes", "gelu_stable",
)
_BLOCK_SCALARS = (
    "s_qact1", "s_attn_qact1", "s_attn1", "s_bias", "s_attn_out", "s_attn_proj",
    "s_res1", "s_qact3", "s_gelu_in", "s_gelu_out", "s_mlp_out", "s_res2",
)
_F32 = np.dtype(np.float32)
_SCALAR = (_F32, ())


def _linear(k: int, n: int, bias: bool = True) -> dict:
    spec = {"w": (np.dtype(np.int8), (k, n)), "out_scale": (_F32, (n,))}
    if bias:
        spec["b"] = (np.dtype(np.int32), (n,))
    return spec


def _norm(d: int) -> dict:
    return {"bias_int": (_F32, (d,)), "out_scale": (_F32, (d,))}


def swin_artifact_spec(cfg: dict) -> dict:
    """The schema of the artifact ``freeze_swin`` writes for ``cfg``: a
    nested dict mirroring it whose leaves are ``(dtype, shape)`` for an
    array, the exact value of an int, or ``None`` where the artifact
    holds ``None`` (``mask_int`` of an unshifted block)."""
    D, p = cfg["embed_dim"], cfg["patch_size"]
    n_stages = len(cfg["depths"])
    stages = []
    for i, (depth, heads) in enumerate(zip(cfg["depths"], cfg["num_heads"])):
        dim = D * 2**i
        hidden = int(dim * cfg["mlp_ratio"])
        blocks = []
        for j in range(depth):
            res, ws, shift = stage_geometry(cfg, i, j)
            N, nW = ws * ws, (res // ws) ** 2
            block = {name: _SCALAR for name in _BLOCK_SCALARS}
            block.update(
                res=res, ws=ws, shift=shift, heads=heads,
                norm1=_norm(dim), qkv=_linear(dim, 3 * dim),
                bias_req=(_F32, (heads, N, N)),
                mask_int=(_F32, (nW, N, N)) if shift else None,
                proj=_linear(dim, dim), norm2=_norm(dim),
                fc1=_linear(dim, hidden), fc2=_linear(hidden, dim),
            )
            blocks.append(block)
        stage = {"blocks": blocks}
        if i < n_stages - 1:
            stage["downsample"] = {
                "res": stage_geometry(cfg, i, 0)[0], "dim": dim, "norm": _norm(4 * dim),
                "s_qact1": _SCALAR, "reduction": _linear(4 * dim, 2 * dim, bias=False),
                "s_out": _SCALAR,
            }
        stages.append(stage)
    nf = D * 2 ** (n_stages - 1)
    return {
        "input_scale": _SCALAR,
        "patch_embed": _linear(p * p * 3, D),
        "s_before_norm": _SCALAR,
        "patch_norm": _norm(D),
        "embed_scale": _SCALAR,
        "tokens_scale": _SCALAR,
        "stages": stages,
        "norm": _norm(nf),
        "s_qact2": _SCALAR,
        "s_qact3": _SCALAR,
        "head": _linear(nf, cfg["num_classes"]),
    }


def validate_swin_artifact(artifact: dict) -> None:
    """Raise ValueError unless ``artifact`` has exactly ``freeze_swin``'s
    keys, dtypes, shapes, window geometry and ``None``s for its own
    ``config``, and that config tiles every stage into whole windows."""
    cfg = artifact.get("config")
    if not isinstance(cfg, dict) or set(cfg) != set(_CONFIG_KEYS):
        raise ValueError(f"artifact['config'] must have keys {sorted(_CONFIG_KEYS)}")
    depths, heads = tuple(cfg["depths"]), tuple(cfg["num_heads"])
    if len(depths) != len(heads) or not depths:
        raise ValueError(f"depths {depths} and num_heads {heads} must be non-empty and of one length")
    if cfg["img_size"] % cfg["patch_size"]:
        raise ValueError("img_size must be a multiple of patch_size")
    for i, h in enumerate(heads):
        res, ws, _ = stage_geometry(cfg, i, 0)
        if (cfg["embed_dim"] * 2**i) % h:
            raise ValueError(f"stage {i}: width {cfg['embed_dim'] * 2**i} is not a multiple of {h} heads")
        if res % ws or (i < len(depths) - 1 and res % 2):
            raise ValueError(f"stage {i}: grid {res} is not tiled by window {ws} (and halved by the merging)")
    check_schema({k: v for k, v in artifact.items() if k != "config"}, swin_artifact_spec(cfg), "")


def swin_artifact_to_torch(artifact: dict, device, validate: bool = True) -> dict:
    """Carry a ``freeze_swin`` artifact onto ``device``: int8 weights
    (K, N), int32 biases, the (H, N, N) bias and (nW, N, N) mask addends,
    and the precomputed float32 ratios (module docstring). Raises
    ``RuntimeError`` for a CUDA device on a machine without one.
    ``validate=False`` skips the schema check, for a tensor-parallel
    shard of a checked artifact (``parallel.tp_infer``)."""
    device = target_device(device)
    if validate:
        validate_swin_artifact(artifact)
    cfg = dict(artifact["config"])
    # 2^-7: the 8-bit probability scale and the ShiftGELU output shift
    s_sm = host_f32(1.0 / 2.0**7)

    def dev(v) -> torch.Tensor:
        return host_f32(v).to(device).contiguous()

    s_before_norm, s_embed, s_tok = (host_f32(artifact[k]) for k in ("s_before_norm", "embed_scale", "tokens_scale"))
    out = {
        "config": cfg,
        "input_scale": dev(artifact["input_scale"]),
        "patch_embed": carry_linear(artifact["patch_embed"], device, s_before_norm),
        "patch_norm": carry_norm(artifact["patch_norm"], device, s_embed),
        "embed_to_tokens": div(s_embed, s_tok).to(device),
    }

    stages, s_x = [], s_tok
    for stage in artifact["stages"]:
        blocks = []
        for blk in stage["blocks"]:
            s = {name: host_f32(blk[name]) for name in _BLOCK_SCALARS}
            hd = blk["qkv"]["w"].shape[0] // blk["heads"]
            sa1, s1, sb = s["s_attn_qact1"], s["s_attn1"], s["s_bias"]
            s_attn = (sa1 * sa1) * host_f32(float(hd) ** -0.5)
            blocks.append({
                "res": blk["res"], "ws": blk["ws"], "shift": blk["shift"], "heads": blk["heads"],
                "norm1": carry_norm(blk["norm1"], device, s["s_qact1"]),
                "qkv": carry_linear(blk["qkv"], device, sa1),
                "attn": {
                    "bias": dev(blk["bias_req"]),
                    "mask": None if blk["mask_int"] is None else dev(blk["mask_int"]),
                    "r1": float(div(s_attn, s1)),
                    "rb": float(div(s1, sb)),
                    "scale": float(sb),
                    "r_out": float(div(s_sm * sa1, s["s_attn_out"])),
                },
                "proj": carry_linear(blk["proj"], device, s["s_attn_proj"]),
                "res1": {"branch": div(s["s_attn_proj"], s["s_res1"]).to(device),
                         "skip": div(s_x, s["s_res1"]).to(device)},
                "norm2": carry_norm(blk["norm2"], device, s["s_qact3"]),
                "fc1": carry_linear(blk["fc1"], device, s["s_gelu_in"]),
                "gelu": {"scale": s["s_gelu_in"].to(device),
                         "ratio": div(s["s_gelu_in"] * s_sm, s["s_gelu_out"]).to(device)},
                "fc2": carry_linear(blk["fc2"], device, s["s_mlp_out"]),
                "res2": {"branch": div(s["s_mlp_out"], s["s_res2"]).to(device),
                         "skip": div(s["s_res1"], s["s_res2"]).to(device)},
            })
            s_x = s["s_res2"]
        carried = {"blocks": blocks}
        if "downsample" in stage:
            ds = stage["downsample"]
            s_out = host_f32(ds["s_out"])
            carried["downsample"] = {
                "res": ds["res"],
                "norm": carry_norm(ds["norm"], device, host_f32(ds["s_qact1"])),
                "reduction": carry_linear(ds["reduction"], device, s_out),
            }
            s_x = s_out
        stages.append(carried)
    out["stages"] = stages
    s_qact2 = host_f32(artifact["s_qact2"])
    out["norm"] = carry_norm(artifact["norm"], device, s_qact2)
    out["pool_ratio"] = div(s_qact2, host_f32(artifact["s_qact3"])).to(device)
    tokens = stage_geometry(cfg, len(cfg["depths"]) - 1, 0)[0] ** 2
    out["inv_tokens"] = div(host_f32(1.0), host_f32(float(tokens))).to(device)  # the pool's 1/L
    out["head"] = carry_linear(artifact["head"], device)
    return out
