"""A seeded, full-width stand-in for a frozen ViT artifact.

Counterpart of what ``bench.py`` runs in JAX — ``model.init(train=True)``
on two sample images, then ``freeze_vit`` — built with numpy and torch
alone, so a machine without JAX can serve a model of real width:

* weights, cls token and pos-embed are truncated-normal with std 0.02
  (flax's initializer: ±2σ, rescaled to unit std), as
  ``ivit_tpu/nn/quant.py:124`` and ``ivit_tpu/models/vit.py:78, 99``;
  biases and LayerNorm γ−1, β are small and random, so every add on the
  path sees nonzero values;
* weights are quantized per output channel with ``core.weight_scale``;
* every activation scale comes from one calibration pass in graph order,
  as a ``QuantAct`` in train mode sets it on its first batch: the
  observed min/max of the real value at that point, through the
  ``_act_scale`` rule (``ivit_tpu/deploy/convert.py:29-39``), and the
  pass continues requantized at that scale.

The result has exactly ``freeze_vit``'s keys, dtypes and shapes
(``deploy.artifact.validate_artifact``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import quantize, symmetric_scale
from ..kernels.attention_fused import attention_probabilities
from ..models import create_config
from ..ops import int_layernorm, requantize, shiftgelu, shiftmax
from ..ops.interp import div
from .artifact import artifact_to_torch, validate_artifact
from .convert import _np, freeze_linear, freeze_norm
from .engine import attention_inputs, embed, int8_linear, vit_block

_TRUNC_STD = 0.87962566103423978  # std of a unit normal truncated to ±2
_CALIB_IMAGES = 2  # bench.py initializes on two sample images


def _act_scale(real: torch.Tensor, bits: int) -> torch.Tensor:
    return symmetric_scale(real.min(), real.max(), bits)


def _matmul_exact(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact product of integer-valued float32 tensors (float64 below 2^53)."""
    return torch.matmul(a.to(torch.float64), b.to(torch.float64)).to(torch.float32)


class _Init:
    """Seeded parameter draws, in a fixed order."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)

    def normal(self, shape, std: float = 1.0) -> torch.Tensor:
        return torch.from_numpy((self.rng.standard_normal(shape) * std).astype(np.float32))

    def trunc_normal(self, shape, std: float = 0.02) -> torch.Tensor:
        x = self.rng.standard_normal(shape)
        bad = np.abs(x) > 2.0
        while bad.any():
            x[bad] = self.rng.standard_normal(int(bad.sum()))
            bad = np.abs(x) > 2.0
        return torch.from_numpy((x * (std / _TRUNC_STD)).astype(np.float32))

    def linear(self, k: int, n: int):
        return self.trunc_normal((k, n)), self.normal((n,), 0.02)

    def norm(self, d: int):
        return 1.0 + self.normal((d,), 0.1), self.normal((d,), 0.02)


def _linear_t(layer: dict) -> dict:
    return {k: torch.from_numpy(layer[k]) for k in ("w", "b") if k in layer}


def _qact(real: torch.Tensor, bits: int, key: str, into: dict) -> torch.Tensor:
    """A ``QuantAct``'s first batch: the scale of ``real`` at ``bits``,
    written to ``into[key]`` as a float32 scalar."""
    s = _act_scale(real, bits)
    into[key] = np.float32(s.item())
    return s


def _calib_linear(x_q: torch.Tensor, params, in_scale: torch.Tensor, key: str, into: dict):
    """Freeze ``params`` (kernel, bias or None) into ``into[key]`` and run
    it on the integer rows ``x_q``: the int32 accumulator (as float32)
    and its per-channel scale."""
    into[key] = layer = freeze_linear(*params, in_scale)
    acc = int8_linear(x_q.to(torch.int8), _linear_t(layer)).to(torch.float32)
    return acc, torch.from_numpy(layer["out_scale"])


def _calib_norm(x_q: torch.Tensor, params, key: str, into: dict):
    """Freeze the LayerNorm ``params`` (γ, β) into ``into[key]`` and run
    the I-LayerNorm on ``x_q``."""
    into[key] = freeze_norm(*params)
    return int_layernorm(x_q, *params)


def _calib_mlp_half(x: torch.Tensor, s_x: torch.Tensor, bp: dict, blk: dict, gelu_stable: bool):
    """The MLP half of a block on the stream ``x`` at ``s_x``: norm2 →
    fc1 → ShiftGELU → fc2 → the second residual, scales set in graph
    order into ``blk``; returns the new stream and its scale."""
    C = x.shape[-1]
    y, s_y = _calib_norm(x, bp["norm2"], "norm2", blk)
    s3 = _qact(y * s_y, 8, "s_qact3", blk)
    y = requantize(y, s_y, s3, 8)
    acc, s_acc = _calib_linear(y.reshape(-1, C), bp["fc1"], s3, "fc1", blk)
    sg_in = _qact(acc * s_acc, 8, "s_gelu_in", blk)
    g, s_g = shiftgelu(requantize(acc, s_acc, sg_in, 8), sg_in, out_bits=8, stable=gelu_stable)
    sg_out = _qact(g * s_g, 8, "s_gelu_out", blk)
    acc, s_acc = _calib_linear(requantize(g, s_g, sg_out, 8), bp["fc2"], sg_out, "fc2", blk)
    smo = _qact(acc * s_acc, 16, "s_mlp_out", blk)
    m = requantize(acc, s_acc, smo, 16).reshape(x.shape)
    sr2 = _qact(m * smo + x * s_x, 16, "s_res2", blk)
    return requantize(m, smo, sr2, 16, x, s_x), sr2


def synthetic_vit_artifact(
    name: str,
    seed: int = 0,
    softmax_bits: int = 8,
    gelu_stable: bool = True,
    **overrides,
) -> dict:
    """A ``freeze_vit``-shaped artifact for registered model ``name``
    (``overrides`` change config fields, e.g. a tiny test size), with
    random weights from ``seed`` and scales calibrated on two seeded
    normal images, with the plain ops on the CPU."""
    cfg = create_config(name, softmax_bits=softmax_bits, gelu_stable=gelu_stable, **overrides)
    D, H, p = cfg["embed_dim"], cfg["num_heads"], cfg["patch_size"]
    hd, hidden, gh = D // H, int(D * cfg["mlp_ratio"]), cfg["img_size"] // p
    init = _Init(seed)

    # parameters, in graph order
    pe_k, pe_b = init.linear(p * p * 3, D)
    cls_token = init.trunc_normal((1, 1, D))
    pos_embed = init.trunc_normal((1, gh * gh + 1, D))
    block_params = [
        {
            "norm1": init.norm(D), "qkv": init.linear(D, 3 * D), "proj": init.linear(D, D),
            "norm2": init.norm(D), "fc1": init.linear(D, hidden), "fc2": init.linear(hidden, D),
        }
        for _ in range(cfg["depth"])
    ]
    norm_params = init.norm(D)
    head_params = init.linear(D, cfg["num_classes"])
    images = init.normal((_CALIB_IMAGES, cfg["img_size"], cfg["img_size"], 3))

    a: dict = {"config": cfg}

    B = _CALIB_IMAGES
    s_in = _qact(images, 8, "input_scale", a)
    x = quantize(images, s_in, 8)
    x = x.reshape(B, gh, p, gh, p, 3).permute(0, 1, 3, 2, 4, 5).reshape(B * gh * gh, p * p * 3)
    acc, s_acc = _calib_linear(x, (pe_k, pe_b), s_in, "patch_embed", a)
    s_embed = _qact(acc * s_acc, 16, "embed_scale", a)
    x = requantize(acc, s_acc, s_embed, 16).reshape(B, gh * gh, D)
    a["cls_q"] = _np(torch.round(div(cls_token, s_embed)), np.float32)
    x = torch.cat([torch.from_numpy(a["cls_q"]).expand(B, 1, D), x], dim=1)
    s_pos = _qact(pos_embed, 16, "pos_scale", a)
    pos_q = quantize(pos_embed, s_pos, 16)
    a["pos_q"] = _np(pos_q, np.float32)
    s_x = _qact(x * s_embed + pos_q * s_pos, 16, "tokens_scale", a)
    x = requantize(x, s_embed, s_x, 16, pos_q, s_pos)

    blocks = []
    for bp in block_params:
        blk: dict = {}
        # attention half
        y, s_y = _calib_norm(x, bp["norm1"], "norm1", blk)
        s1 = _qact(y * s_y, 8, "s_qact1", blk)
        y = requantize(y, s_y, s1, 8)
        acc, s_acc = _calib_linear(y.reshape(-1, D), bp["qkv"], s1, "qkv", blk)
        sa1 = _qact(acc * s_acc, 8, "s_attn_qact1", blk)
        z = requantize(acc, s_acc, sa1, 8).reshape(B, -1, 3, H, hd).permute(2, 0, 3, 1, 4)
        q, k, v = z[0], z[1], z[2]
        attn = _matmul_exact(q, k.transpose(-1, -2))
        s_attn = (sa1 * sa1) * np.float32(hd**-0.5)
        ssm = _qact(attn * s_attn, 8, "s_attn_sm_in", blk)
        sm, s_sm = shiftmax(requantize(attn, s_attn, ssm, 8), ssm, out_bits=softmax_bits)
        ctx = _matmul_exact(sm, v)
        s_ctx = s_sm * sa1
        sao = _qact(ctx * s_ctx, 8, "s_attn_out", blk)
        ctx = requantize(ctx, s_ctx, sao, 8).permute(0, 2, 1, 3).reshape(-1, D)
        acc, s_acc = _calib_linear(ctx, bp["proj"], sao, "proj", blk)
        sap = _qact(acc * s_acc, 16, "s_attn_proj", blk)
        branch = requantize(acc, s_acc, sap, 16).reshape(x.shape)
        sr1 = _qact(branch * sap + x * s_x, 16, "s_res1", blk)
        x = requantize(branch, sap, sr1, 16, x, s_x)
        x, s_x = _calib_mlp_half(x, sr1, bp, blk, gelu_stable)
        blocks.append(blk)
    a["blocks"] = blocks

    y, s_y = _calib_norm(x, norm_params, "norm", a)
    cls = y[:, 0]
    s_head = _qact(cls * s_y, 8, "head_in_scale", a)
    a["head"] = freeze_linear(*head_params, s_head)
    validate_artifact(a)
    return a


def nonzero_probability_share(artifact: dict, images: torch.Tensor, device="cuda") -> list[float]:
    """Per block, the share of attention probabilities that are nonzero
    when the plain engine runs ``images`` on ``device`` — a degeneracy
    check: at 8-bit probabilities, a diffuse row floors to all zeros."""
    t = artifact_to_torch(artifact, device)
    cfg = t["config"]
    shares = []
    with torch.inference_mode():
        x = embed(images.to(device=device, dtype=torch.float32), t)
        for blk in t["blocks"]:
            q, k, _ = attention_inputs(x, blk, cfg["num_heads"], kernels=())
            a = blk["attn"]
            sm = attention_probabilities(q, k, a["r1"], a["scale"], int(cfg["softmax_bits"]))
            shares.append(float((sm > 0).to(torch.float32).mean()))
            x = vit_block(x, blk, cfg, kernels=())
    return shares
