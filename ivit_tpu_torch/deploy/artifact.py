"""The frozen ViT artifact: its schema, and its carry-over into torch.

The artifact is what ``ivit_tpu/deploy/convert.py:freeze_vit`` returns: a
nested dict of numpy arrays (int8 weights (K, N), int32 biases, float32
scale vectors and float32 scalars) plus a ``config`` dict. The port
freezes its own QAT models (``deploy.convert.freeze_vit``), reads JAX's
artifacts (``utils.artifact.load_artifact``) or builds a seeded stand-in
(``deploy.synthetic``).

``artifact_to_torch`` moves the arrays onto a device and precomputes
every requantization ratio once, in float32 tensor ops in the order the
JAX engine's XLA path divides them on its device
(``ivit_tpu/deploy/engine.py:126, 381, 395-398, 622, 740``). The fused
attention ratios ``r1``/``r_out``, the softmax input scale, and the GELU
input scale ``s_in`` and output ratio ``r2`` also come back as Python
floats holding float32 values (kernel arguments); fc1 also carries its
weight K-contiguous as ``w_t`` (C, K), the layout K4 reads. Every ratio
a forward's tensor ops read is a device tensor made here, so a forward
copies nothing from the host.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.device import target_device
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


def check_schema(value, spec, path: str) -> None:
    """Hold ``value`` to ``spec``: a dict or list of specs, a
    ``(dtype, shape)`` array leaf, an exact integer, or ``None``."""
    if isinstance(spec, dict):
        if not isinstance(value, dict) or set(value) != set(spec):
            got = sorted(value) if isinstance(value, dict) else type(value).__name__
            raise ValueError(f"artifact{path}: expected keys {sorted(spec)}, got {got}")
        for key, sub in spec.items():
            check_schema(value[key], sub, f"{path}[{key!r}]")
    elif isinstance(spec, list):
        if not isinstance(value, (list, tuple)) or len(value) != len(spec):
            raise ValueError(f"artifact{path}: expected a list of {len(spec)} blocks")
        for i, (v, s) in enumerate(zip(value, spec)):
            check_schema(v, s, f"{path}[{i}]")
    elif spec is None:
        if value is not None:
            raise ValueError(f"artifact{path}: expected None, got {type(value).__name__}")
    elif isinstance(spec, int):
        if isinstance(value, bool) or not isinstance(value, (int, np.integer)) or value != spec:
            raise ValueError(f"artifact{path}: expected the integer {spec}, got {value!r}")
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
    check_schema({k: v for k, v in artifact.items() if k != "config"}, artifact_spec(cfg), "")


def host_f32(v) -> torch.Tensor:
    """A float32 tensor on the host, where every ratio is divided."""
    return torch.from_numpy(np.array(v, dtype=np.float32))


def carry_linear(layer: dict, device, s_next=None) -> dict:
    """A frozen linear on ``device``: int8 ``w`` (K, N), the int32 ``b``
    where the layer has one, and either the requant ``ratio``
    ``out_scale / s_next`` or, without ``s_next``, the ``out_scale``.

    CUDA's ``torch._int_mm`` takes only K and N that are multiples of 8,
    so a ``w`` of other widths is carried zero-padded up to them, with
    the true N as ``n``; ``deploy.engine.int8_linear`` pads x's columns
    to match and cuts the product back to N. Zero rows and columns change
    no integer. ``b`` and the scales keep their N entries."""
    out = {k: torch.tensor(np.asarray(layer[k])).to(device) for k in ("w", "b") if k in layer}
    K, N = out["w"].shape
    if K % 8 or N % 8:
        out["w"] = torch.nn.functional.pad(out["w"], (0, -N % 8, 0, -K % 8))
        out["n"] = N
    if s_next is None:
        out["out_scale"] = host_f32(layer["out_scale"]).to(device)
    else:
        out["ratio"] = div(host_f32(layer["out_scale"]), s_next).to(device)
    return out


def carry_norm(nrm: dict, device, s_next) -> dict:
    """A frozen I-LayerNorm on ``device``: the folded β and the requant
    ratio ``out_scale / s_next``."""
    return {"bias_int": host_f32(nrm["bias_int"]).to(device),
            "ratio": div(host_f32(nrm["out_scale"]), s_next).to(device)}


def artifact_to_torch(artifact: dict, device, validate: bool = True) -> dict:
    """Carry a frozen artifact onto ``device``: int8 weights (K, N),
    int32 biases, float32 scales and the precomputed float32 ratios; each
    block's head count as ``heads``. Raises ``RuntimeError`` for a CUDA
    device on a machine without one. ``validate=False`` skips the schema
    check, for a tensor-parallel shard of a checked artifact
    (``parallel.tp_infer``), whose sharded layers are narrower."""
    device = target_device(device)
    if validate:
        validate_artifact(artifact)
    cfg = dict(artifact["config"])
    D, H = cfg["embed_dim"], cfg["num_heads"]
    sm_bits = int(cfg["softmax_bits"])
    # f32 scalars, as the JAX engine's ratio arithmetic uses them
    qk_scale = torch.tensor(np.float32(float(D // H) ** -0.5))
    s_sm = torch.tensor(np.float32(1.0 / 2.0 ** (sm_bits - 1)))
    g_shift = torch.tensor(np.float32(1.0 / 2.0**7))

    def dev(t: torch.Tensor) -> torch.Tensor:
        return t.to(device).contiguous()

    s_embed = host_f32(artifact["embed_scale"])
    s_tok = host_f32(artifact["tokens_scale"])
    out = {
        "config": cfg,
        "input_scale": dev(host_f32(artifact["input_scale"])),
        "patch_embed": carry_linear(artifact["patch_embed"], device, s_embed),
        "cls_q": dev(host_f32(artifact["cls_q"])),
        "embed_to_tokens": dev(div(s_embed, s_tok)),
        "pos": dev(torch.round(host_f32(artifact["pos_q"]) * div(host_f32(artifact["pos_scale"]), s_tok))),
    }

    blocks = []
    s_x = s_tok
    for blk in artifact["blocks"]:
        s = {name: host_f32(blk[name]) for name in _BLOCK_SCALARS}
        sa1, ssm = s["s_attn_qact1"], s["s_attn_sm_in"]
        gelu_ratio = div(s["s_gelu_in"] * g_shift, s["s_gelu_out"])
        fc1 = carry_linear(blk["fc1"], device, s["s_gelu_in"])
        k, n = np.shape(blk["fc1"]["w"])
        fc1["w_t"] = fc1["w"][:k, :n].T.contiguous()  # K-contiguous for K4, unpadded
        r_out = div(s_sm * sa1, s["s_attn_out"])
        blocks.append({
            "heads": H,
            "norm1": carry_norm(blk["norm1"], device, s["s_qact1"]),
            "qkv": carry_linear(blk["qkv"], device, sa1),
            "attn": {
                "r1": float(div((sa1 * sa1) * qk_scale, ssm)),
                "scale": float(ssm),
                "r_out": float(r_out),
                "ratio_out": dev(r_out),  # r_out on the device, for route B's plain @V requant
            },
            "proj": carry_linear(blk["proj"], device, s["s_attn_proj"]),
            "res1": {"branch": dev(div(s["s_attn_proj"], s["s_res1"])),
                     "skip": dev(div(s_x, s["s_res1"]))},
            "norm2": carry_norm(blk["norm2"], device, s["s_qact3"]),
            "fc1": fc1,
            "gelu": {"scale": dev(s["s_gelu_in"]), "ratio": dev(gelu_ratio),
                     "s_in": float(s["s_gelu_in"]), "r2": float(gelu_ratio)},
            "fc2": carry_linear(blk["fc2"], device, s["s_mlp_out"]),
            "res2": {"branch": dev(div(s["s_mlp_out"], s["s_res2"])),
                     "skip": dev(div(s["s_res1"], s["s_res2"]))},
        })
        s_x = s["s_res2"]
    out["blocks"] = blocks
    out["norm"] = carry_norm(artifact["norm"], device, host_f32(artifact["head_in_scale"]))
    out["head"] = carry_linear(artifact["head"], device)
    return out
