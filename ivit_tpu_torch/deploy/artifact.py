"""The frozen ViT artifact: its schema, and its carry-over into torch.

The artifact is what ``ivit_tpu/deploy/convert.py:freeze_vit`` returns: a
nested dict of numpy arrays (int8 weights (K, N), int32 biases, float32
scale vectors and float32 scalars) plus a ``config`` dict. Freezing
stays in JAX; the port reads its artifacts (``utils.artifact.load_artifact``)
or builds a seeded stand-in (``deploy.synthetic``).

``artifact_to_torch`` moves the arrays onto a device and precomputes
every requantization ratio once, in float32 tensor ops in the order the
JAX engine's XLA path divides them on its device
(``ivit_tpu/deploy/engine.py:126, 381, 395-398, 622, 740``). The fused
attention ratios ``r1``/``r_out`` and the softmax input scale come back
as Python floats holding float32 values (kernel arguments).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.interp import div

_CONFIG_KEYS = (
    "img_size", "patch_size", "embed_dim", "depth", "num_heads",
    "mlp_ratio", "num_classes", "softmax_bits", "gelu_stable",
)
_BLOCK_SCALARS = (
    "s_qact1", "s_attn_qact1", "s_attn_sm_in", "s_attn_out", "s_attn_proj",
    "s_res1", "s_qact3", "s_gelu_in", "s_gelu_out", "s_mlp_out", "s_res2",
)


def artifact_spec(cfg: dict) -> dict:
    """The (dtype, shape) of every array ``freeze_vit`` writes for ``cfg``,
    as a nested dict mirroring the artifact (``blocks`` is a list)."""
    D = cfg["embed_dim"]
    p = cfg["patch_size"]
    n_tokens = (cfg["img_size"] // p) ** 2 + 1
    hidden = int(D * cfg["mlp_ratio"])
    f32, scalar = np.dtype(np.float32), (np.dtype(np.float32), ())

    def linear(k, n):
        return {"w": (np.dtype(np.int8), (k, n)), "b": (np.dtype(np.int32), (n,)), "out_scale": (f32, (n,))}

    def norm():
        return {"bias_int": (f32, (D,)), "out_scale": (f32, (D,))}

    block = {name: scalar for name in _BLOCK_SCALARS}
    block.update(
        norm1=norm(), qkv=linear(D, 3 * D), proj=linear(D, D),
        norm2=norm(), fc1=linear(D, hidden), fc2=linear(hidden, D),
    )
    return {
        "input_scale": scalar,
        "patch_embed": linear(p * p * 3, D),
        "embed_scale": scalar,
        "cls_q": (f32, (1, 1, D)),
        "pos_q": (f32, (1, n_tokens, D)),
        "pos_scale": scalar,
        "tokens_scale": scalar,
        "blocks": [block] * cfg["depth"],
        "norm": norm(),
        "head_in_scale": scalar,
        "head": linear(D, cfg["num_classes"]),
    }


def _validate(value, spec, path: str) -> None:
    if isinstance(spec, dict):
        if not isinstance(value, dict) or set(value) != set(spec):
            got = sorted(value) if isinstance(value, dict) else type(value).__name__
            raise ValueError(f"artifact{path}: expected keys {sorted(spec)}, got {got}")
        for key, sub in spec.items():
            _validate(value[key], sub, f"{path}[{key!r}]")
    elif isinstance(spec, list):
        if not isinstance(value, (list, tuple)) or len(value) != len(spec):
            raise ValueError(f"artifact{path}: expected a list of {len(spec)} blocks")
        for i, (v, s) in enumerate(zip(value, spec)):
            _validate(v, s, f"{path}[{i}]")
    else:
        dtype, shape = spec
        arr = np.asarray(value)
        if arr.dtype != dtype or arr.shape != shape:
            raise ValueError(f"artifact{path}: expected {dtype}{shape}, got {arr.dtype}{arr.shape}")


def validate_artifact(artifact: dict) -> None:
    """Raise ValueError unless ``artifact`` has exactly ``freeze_vit``'s
    keys, dtypes and shapes for its own ``config``."""
    cfg = artifact.get("config")
    if not isinstance(cfg, dict) or set(cfg) != set(_CONFIG_KEYS):
        raise ValueError(f"artifact['config'] must have keys {sorted(_CONFIG_KEYS)}")
    if int(cfg["softmax_bits"]) not in (8, 16):
        raise ValueError(f"softmax_bits must be 8 or 16, got {cfg['softmax_bits']}")
    if cfg["embed_dim"] % cfg["num_heads"]:
        raise ValueError("embed_dim must be a multiple of num_heads")
    _validate({k: v for k, v in artifact.items() if k != "config"}, artifact_spec(cfg), "")


def artifact_to_torch(artifact: dict, device) -> dict:
    """Carry a frozen artifact onto ``device``: int8 weights (K, N),
    int32 biases, float32 scales and the precomputed float32 ratios."""
    validate_artifact(artifact)
    cfg = dict(artifact["config"])
    D, H = cfg["embed_dim"], cfg["num_heads"]
    sm_bits = int(cfg["softmax_bits"])
    # f32 scalars, as the JAX engine's ratio arithmetic uses them
    qk_scale = torch.tensor(np.float32(float(D // H) ** -0.5))
    s_sm = torch.tensor(np.float32(1.0 / 2.0 ** (sm_bits - 1)))
    g_shift = torch.tensor(np.float32(1.0 / 2.0**7))

    def f32(v) -> torch.Tensor:  # on the host: every ratio is divided there
        return torch.from_numpy(np.array(v, dtype=np.float32))

    def dev(t: torch.Tensor) -> torch.Tensor:
        return t.to(device).contiguous()

    def linear(layer, s_next=None):
        out = {"w": dev(torch.tensor(np.asarray(layer["w"]))),
               "b": dev(torch.tensor(np.asarray(layer["b"])))}
        if s_next is None:
            out["out_scale"] = dev(f32(layer["out_scale"]))
        else:
            out["ratio"] = dev(div(f32(layer["out_scale"]), s_next))
        return out

    def norm(nrm, s_next):
        return {"bias_int": dev(f32(nrm["bias_int"])),
                "ratio": dev(div(f32(nrm["out_scale"]), s_next))}

    s_embed = f32(artifact["embed_scale"])
    s_tok = f32(artifact["tokens_scale"])
    out = {
        "config": cfg,
        "input_scale": dev(f32(artifact["input_scale"])),
        "patch_embed": linear(artifact["patch_embed"], s_embed),
        "cls_q": dev(f32(artifact["cls_q"])),
        "embed_to_tokens": dev(div(s_embed, s_tok)),
        "pos": dev(torch.round(f32(artifact["pos_q"]) * div(f32(artifact["pos_scale"]), s_tok))),
    }

    blocks = []
    s_x = s_tok
    for blk in artifact["blocks"]:
        s = {name: f32(blk[name]) for name in _BLOCK_SCALARS}
        sa1, ssm = s["s_attn_qact1"], s["s_attn_sm_in"]
        blocks.append({
            "norm1": norm(blk["norm1"], s["s_qact1"]),
            "qkv": linear(blk["qkv"], sa1),
            "attn": {
                "r1": float(div((sa1 * sa1) * qk_scale, ssm)),
                "scale": float(ssm),
                "r_out": float(div(s_sm * sa1, s["s_attn_out"])),
            },
            "proj": linear(blk["proj"], s["s_attn_proj"]),
            "res1": {"branch": dev(div(s["s_attn_proj"], s["s_res1"])),
                     "skip": dev(div(s_x, s["s_res1"]))},
            "norm2": norm(blk["norm2"], s["s_qact3"]),
            "fc1": linear(blk["fc1"], s["s_gelu_in"]),
            "gelu": {"scale": dev(s["s_gelu_in"]),
                     "ratio": dev(div(s["s_gelu_in"] * g_shift, s["s_gelu_out"]))},
            "fc2": linear(blk["fc2"], s["s_mlp_out"]),
            "res2": {"branch": dev(div(s["s_mlp_out"], s["s_res2"])),
                     "skip": dev(div(s["s_res1"], s["s_res2"]))},
        })
        s_x = s["s_res2"]
    out["blocks"] = blocks
    out["norm"] = norm(artifact["norm"], f32(artifact["head_in_scale"]))
    out["head"] = linear(artifact["head"])
    return out
