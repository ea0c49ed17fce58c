"""Freeze a trained QAT ViT into the integer artifact the engines serve.

Counterpart of ``ivit_tpu/deploy/convert.py:freeze_vit``: weights are
quantized once from the trained parameters by the same ops the QAT
layers run every step (``core.ste.quantize`` at ``core.weight_scale``),
activation scales come from the frozen EMA ranges (``symmetric_scale``
of each ``QuantAct``'s ``min_val``/``max_val``), and every array is
numpy: int8 weights, int32 biases, float32 scales. The freezing runs on
the device the model trained on, as JAX's runs its jitted ops on the
deployment device, so that the integers are the ones the model saw.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import quantize, symmetric_scale, weight_scale
from ..core.device import target_device
from ..models.model_utils import model_variables
from ..ops.interp import div, f32
from .artifact import validate_artifact


def _np(t: torch.Tensor, dtype) -> np.ndarray:
    return t.detach().cpu().numpy().astype(dtype)


def freeze_linear(kernel: torch.Tensor, bias: torch.Tensor | None, in_scale: torch.Tensor) -> dict:
    """A ``QuantLinear``'s (kernel (in, out), bias or None) at input
    scale ``in_scale``: int8 ``w``, the int32 ``b`` where there is a
    bias, and the per-channel ``out_scale = w_scale · in_scale``."""
    w_scale = weight_scale(kernel.T, 8)
    out_scale = w_scale * in_scale
    layer = {"w": _np(quantize(kernel, w_scale, 8), np.int8), "out_scale": _np(out_scale, np.float32)}
    if bias is not None:
        layer["b"] = _np(quantize(bias, out_scale, 32), np.float64).astype(np.int32)
    return layer


def freeze_norm(gamma: torch.Tensor, beta: torch.Tensor) -> dict:
    """An ``IntLayerNorm``'s (γ, β): the integer bias ``⌊(β/γ)/base⌋``
    and the per-channel ``out_scale = γ·base``, ``base = √D/2^30``."""
    base = f32(np.sqrt(gamma.shape[0]) / 2.0**30, gamma.device)
    return {
        "bias_int": _np(torch.floor(div(div(beta, gamma), base)), np.float32),
        "out_scale": _np(gamma * base, np.float32),
    }


class TrainedVariables:
    """A QAT model's variables (``{"params", "quant_stats"}`` keyed by
    torch name, as ``models.model_utils.eval_variables`` gives them; the
    model's own when None) on the device freezing runs on (raises for a
    CUDA device on a machine without one), read as the artifact holds
    them: a ``QuantAct``'s scale, a ``QuantLinear``, an ``IntLayerNorm``."""

    def __init__(self, model: torch.nn.Module, variables: dict | None, device):
        device = target_device(device)
        if variables is None:
            variables = model_variables(model)
        self.params = {k: t.detach().to(device) for k, t in variables["params"].items()}
        self.stats = {k: t.detach().to(device) for k, t in variables["quant_stats"].items()}

    def act(self, name: str, bits: int) -> torch.Tensor:
        return symmetric_scale(self.stats[f"{name}.min_val"], self.stats[f"{name}.max_val"], bits)

    def linear(self, name: str, in_scale: torch.Tensor) -> dict:
        return freeze_linear(self.params[f"{name}.kernel"], self.params.get(f"{name}.bias"), in_scale)

    def norm(self, name: str) -> dict:
        return freeze_norm(self.params[f"{name}.scale"], self.params[f"{name}.bias"])


def scalar(s: torch.Tensor) -> np.float32:
    """A scale as the artifact holds it."""
    return np.float32(s.item())


def freeze_vit(model: torch.nn.Module, variables: dict | None = None, device="cuda") -> dict:
    """The artifact of the QAT ``VisionTransformer`` ``model`` on
    ``variables`` (``{"params", "quant_stats"}`` keyed by torch name, as
    ``models.model_utils.eval_variables`` gives them; the model's own
    when None), computed on ``device`` (raises for a CUDA device on a
    machine without one). It has ``freeze_vit``'s keys, dtypes and
    shapes (``deploy.artifact.validate_artifact``)."""
    v = TrainedVariables(model, variables, device)
    act, linear, norm, params = v.act, v.linear, v.norm, v.params
    cfg = dict(model.config)

    a: dict = {"config": cfg}
    s_input = act("qact_input", 8)
    a["input_scale"] = scalar(s_input)
    a["patch_embed"] = linear("patch_embed.proj", s_input)
    s_embed = act("qact_embed", 16)
    a["embed_scale"] = scalar(s_embed)
    # the cls token at the embed scale, the pos-embed at its own 16-bit one
    a["cls_q"] = _np(torch.round(div(params["cls_token"], s_embed)), np.float32)
    s_pos = act("qact_pos", 16)
    a["pos_q"] = _np(quantize(params["pos_embed"], s_pos, 16), np.float32)
    a["pos_scale"] = scalar(s_pos)
    a["tokens_scale"] = scalar(act("qact1", 16))

    blocks = []
    for i in range(cfg["depth"]):
        b = f"blocks_{i}"
        s_qact1 = act(f"{b}.qact1", 8)
        s_attn_out = act(f"{b}.attn.qact2", 8)
        s_qact3 = act(f"{b}.qact3", 8)
        s_gelu_out = act(f"{b}.mlp.qact1", 8)
        blocks.append({
            "norm1": norm(f"{b}.norm1"),
            "s_qact1": scalar(s_qact1),
            "qkv": linear(f"{b}.attn.qkv", s_qact1),
            "s_attn_qact1": scalar(act(f"{b}.attn.qact1", 8)),
            "s_attn_sm_in": scalar(act(f"{b}.attn.qact_attn1", 8)),
            "s_attn_out": scalar(s_attn_out),
            "proj": linear(f"{b}.attn.proj", s_attn_out),
            "s_attn_proj": scalar(act(f"{b}.attn.qact3", 16)),
            "s_res1": scalar(act(f"{b}.qact2", 16)),
            "norm2": norm(f"{b}.norm2"),
            "s_qact3": scalar(s_qact3),
            "fc1": linear(f"{b}.mlp.fc1", s_qact3),
            "s_gelu_in": scalar(act(f"{b}.mlp.qact_gelu", 8)),
            "s_gelu_out": scalar(s_gelu_out),
            "fc2": linear(f"{b}.mlp.fc2", s_gelu_out),
            "s_mlp_out": scalar(act(f"{b}.mlp.qact2", 16)),
            "s_res2": scalar(act(f"{b}.qact4", 16)),
        })
    a["blocks"] = blocks

    a["norm"] = norm("norm")
    s_head = act("qact2", 8)
    a["head_in_scale"] = scalar(s_head)
    a["head"] = linear("head", s_head)
    validate_artifact(a)
    return a
