"""The integer-only ViT/DeiT (I-ViT) in plain torch: seeded weights, the
calibration that freezes them into an artifact, and the integer forward
that judges what the served engine returns.

* ``make_params`` draws the float parameters from a seed on the device.
* ``calibrate`` freezes them: weights per output channel to int8, every
  activation scale from one pass in graph order over calibration images
  (the observed min/max of the real value at that point, as a
  ``QuantAct`` sets it on its first batch), continuing requantized at
  that scale. The result is the frozen artifact the served engine takes:
  int8 weights, int32 biases, float32 scales.
* ``carry`` works out, from the artifact alone, every requantization
  ratio the forward uses (float32, on the host), and ``forward`` runs the
  integer model: input quantization, patch embed, the blocks (I-LayerNorm
  → requant, the qkv GEMM, int8 Q·Kᵀ → requant → Shiftmax → @V →
  requant, proj, the 16-bit dual-scale residual, I-LayerNorm, fc1 →
  ShiftGELU → requant, fc2, the residual), the final norm on the class
  token and the head, whose int32 accumulator times its scale are the
  logits.

Integer products run in float64 (exact). Nothing here comes from the
program under test.
"""

from __future__ import annotations

import numpy as np
import torch

from . import intops as ops
from .weights import Draws, linear_size

_CALIB_IMAGES = 2


def _geometry(cfg: dict):
    D, H, p = cfg["embed_dim"], cfg["num_heads"], cfg["patch_size"]
    gh = cfg["img_size"] // p
    return D, H, p, gh, D // H, int(D * cfg["mlp_ratio"])


def param_count(cfg: dict) -> int:
    D, _, p, gh, _, hidden = _geometry(cfg)
    block = 4 * D + linear_size(D, 3 * D) + linear_size(D, D) + linear_size(D, hidden) + linear_size(hidden, D)
    return (linear_size(p * p * 3, D) + D + (gh * gh + 1) * D + cfg["depth"] * block + 2 * D
            + linear_size(D, cfg["num_classes"]))


def make_params(cfg: dict, generator: torch.Generator, device) -> dict:
    """The float parameters of ``cfg``'s model, in graph order."""
    D, _, p, gh, _, hidden = _geometry(cfg)
    d = Draws(param_count(cfg), generator, device)
    params = {
        "patch_embed": d.linear(p * p * 3, D),
        "cls_token": d.trunc_normal((1, 1, D)),
        "pos_embed": d.trunc_normal((1, gh * gh + 1, D)),
        "blocks": [
            {"norm1": d.norm(D), "qkv": d.linear(D, 3 * D), "proj": d.linear(D, D),
             "norm2": d.norm(D), "fc1": d.linear(D, hidden), "fc2": d.linear(hidden, D)}
            for _ in range(cfg["depth"])
        ],
        "norm": d.norm(D),
        "head": d.linear(D, cfg["num_classes"]),
    }
    return params


def _np(t: torch.Tensor, dtype) -> np.ndarray:
    return t.detach().cpu().numpy().astype(dtype)


def freeze_linear(kernel: torch.Tensor, bias, in_scale: torch.Tensor) -> dict:
    """int8 ``w`` (K, N), int32 ``b`` and the per-channel ``out_scale =
    w_scale · in_scale`` of a linear layer at input scale ``in_scale``."""
    w_scale = ops.weight_scale(kernel.T, 8)
    out_scale = w_scale * in_scale
    layer = {"w": _np(ops.quantize(kernel, w_scale, 8), np.int8), "out_scale": _np(out_scale, np.float32)}
    if bias is not None:
        layer["b"] = _np(ops.quantize(bias, out_scale, 32), np.float64).astype(np.int32)
    return layer


def freeze_norm(gamma: torch.Tensor, beta: torch.Tensor) -> dict:
    return {"bias_int": _np(ops.layernorm_bias(gamma, beta), np.float32),
            "out_scale": _np(ops.layernorm_scale(gamma), np.float32)}


class Calibration:
    """The pass that sets the scales: each ``act`` records one."""

    def __init__(self, device):
        self.device = device

    def act(self, real: torch.Tensor, bits: int, key: str, into: dict) -> torch.Tensor:
        s = ops.symmetric_scale(real.min(), real.max(), bits)
        into[key] = np.float32(s.item())
        return ops.scalar(into[key], self.device)

    def linear(self, x_q, params, in_scale, key: str, into: dict):
        """Freeze ``params`` into ``into[key]``; the float32 accumulator of
        the integer rows ``x_q`` and its per-channel scale."""
        into[key] = layer = freeze_linear(*params, in_scale)
        w = torch.from_numpy(layer["w"]).to(self.device)
        acc = ops.int8_gemm(x_q, w)
        if "b" in layer:
            acc = acc + torch.from_numpy(layer["b"]).to(self.device)
        return acc.to(torch.float32), torch.from_numpy(layer["out_scale"]).to(self.device)

    def norm(self, x_q, params, key: str, into: dict):
        """Freeze the LayerNorm (γ, β) into ``into[key]``; its integer
        output on ``x_q`` and the per-channel output scale."""
        gamma, beta = params
        into[key] = freeze_norm(gamma, beta)
        return ops.layernorm_int(x_q) + ops.layernorm_bias(gamma, beta), ops.layernorm_scale(gamma)

    def mlp_half(self, x, s_x, bp: dict, blk: dict, stable: bool):
        """norm2 → fc1 → ShiftGELU → fc2 → the second residual."""
        C = x.shape[-1]
        y, s_y = self.norm(x, bp["norm2"], "norm2", blk)
        s3 = self.act(y * s_y, 8, "s_qact3", blk)
        y = ops.requantize(y, s_y, s3, 8)
        acc, s_acc = self.linear(y.reshape(-1, C), bp["fc1"], s3, "fc1", blk)
        sg_in = self.act(acc * s_acc, 8, "s_gelu_in", blk)
        g = ops.shiftgelu(ops.requantize(acc, s_acc, sg_in, 8), sg_in, stable)
        s_g = sg_in * (1.0 / 2.0**7)
        sg_out = self.act(g * s_g, 8, "s_gelu_out", blk)
        acc, s_acc = self.linear(ops.requantize(g, s_g, sg_out, 8), bp["fc2"], sg_out, "fc2", blk)
        smo = self.act(acc * s_acc, 16, "s_mlp_out", blk)
        m = ops.requantize(acc, s_acc, smo, 16).reshape(x.shape)
        sr2 = self.act(m * smo + x * s_x, 16, "s_res2", blk)
        return ops.requantize(m, smo, sr2, 16, x, s_x), sr2


def calibrate(cfg: dict, params: dict, images: torch.Tensor) -> dict:
    """The frozen artifact of ``params`` with scales set on ``images``
    (NHWC float32, on the parameters' device)."""
    D, H, p, gh, hd, _ = _geometry(cfg)
    c = Calibration(images.device)
    a: dict = {"config": dict(cfg)}
    B = images.shape[0]
    s_in = c.act(images, 8, "input_scale", a)
    x = ops.quantize(images, s_in, 8)
    x = x.reshape(B, gh, p, gh, p, 3).permute(0, 1, 3, 2, 4, 5).reshape(B * gh * gh, p * p * 3)
    acc, s_acc = c.linear(x, params["patch_embed"], s_in, "patch_embed", a)
    s_embed = c.act(acc * s_acc, 16, "embed_scale", a)
    x = ops.requantize(acc, s_acc, s_embed, 16).reshape(B, gh * gh, D)
    cls_q = torch.round(ops.div(params["cls_token"], s_embed))
    a["cls_q"] = _np(cls_q, np.float32)
    x = torch.cat([cls_q.expand(B, 1, D), x], dim=1)
    s_pos = c.act(params["pos_embed"], 16, "pos_scale", a)
    pos_q = ops.quantize(params["pos_embed"], s_pos, 16)
    a["pos_q"] = _np(pos_q, np.float32)
    s_x = c.act(x * s_embed + pos_q * s_pos, 16, "tokens_scale", a)
    x = ops.requantize(x, s_embed, s_x, 16, pos_q, s_pos)

    blocks = []
    for bp in params["blocks"]:
        blk: dict = {}
        y, s_y = c.norm(x, bp["norm1"], "norm1", blk)
        s1 = c.act(y * s_y, 8, "s_qact1", blk)
        y = ops.requantize(y, s_y, s1, 8)
        acc, s_acc = c.linear(y.reshape(-1, D), bp["qkv"], s1, "qkv", blk)
        sa1 = c.act(acc * s_acc, 8, "s_attn_qact1", blk)
        z = ops.requantize(acc, s_acc, sa1, 8).reshape(B, -1, 3, H, hd).permute(2, 0, 3, 1, 4)
        attn = ops.exact_matmul(z[0], z[1].transpose(-1, -2)).to(torch.float32)
        s_attn = (sa1 * sa1) * np.float32(hd**-0.5)
        ssm = c.act(attn * s_attn, 8, "s_attn_sm_in", blk)
        sm = ops.shiftmax(ops.requantize(attn, s_attn, ssm, 8), ssm, out_bits=int(cfg["softmax_bits"]))
        s_sm = ops.scalar(1.0 / 2.0 ** (int(cfg["softmax_bits"]) - 1), images.device)
        ctx = ops.exact_matmul(sm, z[2]).to(torch.float32)
        s_ctx = s_sm * sa1
        sao = c.act(ctx * s_ctx, 8, "s_attn_out", blk)
        ctx = ops.requantize(ctx, s_ctx, sao, 8).permute(0, 2, 1, 3).reshape(-1, D)
        acc, s_acc = c.linear(ctx, bp["proj"], sao, "proj", blk)
        sap = c.act(acc * s_acc, 16, "s_attn_proj", blk)
        branch = ops.requantize(acc, s_acc, sap, 16).reshape(x.shape)
        sr1 = c.act(branch * sap + x * s_x, 16, "s_res1", blk)
        x = ops.requantize(branch, sap, sr1, 16, x, s_x)
        x, s_x = c.mlp_half(x, sr1, bp, blk, bool(cfg["gelu_stable"]))
        blocks.append(blk)
    a["blocks"] = blocks

    y, s_y = c.norm(x, params["norm"], "norm", a)
    s_head = c.act(y[:, 0] * s_y, 8, "head_in_scale", a)
    a["head"] = freeze_linear(*params["head"], s_head)
    return a


# ---- the forward on a frozen artifact -------------------------------------------------

def _f32(v) -> torch.Tensor:
    return torch.from_numpy(np.array(v, dtype=np.float32))


def carry_linear(layer: dict, device, s_next=None) -> dict:
    out = {"w": torch.from_numpy(np.asarray(layer["w"])).to(device)}
    if "b" in layer:
        out["b"] = torch.from_numpy(np.asarray(layer["b"])).to(device)
    if s_next is None:
        out["out_scale"] = _f32(layer["out_scale"]).to(device)
    else:
        out["ratio"] = ops.div(_f32(layer["out_scale"]), s_next).to(device)
    return out


def carry_norm(nrm: dict, device, s_next) -> dict:
    return {"bias_int": _f32(nrm["bias_int"]).to(device),
            "ratio": ops.div(_f32(nrm["out_scale"]), s_next).to(device)}


def linear(x: torch.Tensor, layer: dict, weight_bits: int) -> torch.Tensor:
    acc = ops.int8_gemm(x, layer["w"], weight_bits)
    return acc + layer["b"] if "b" in layer else acc


def carry(artifact: dict, device) -> dict:
    """The artifact's tensors on ``device`` with every ratio divided once
    in float32 on the host."""
    cfg = dict(artifact["config"])
    D, H = cfg["embed_dim"], cfg["num_heads"]
    bits = int(cfg["softmax_bits"])
    qk_scale = _f32(float(D // H) ** -0.5)
    s_sm = _f32(1.0 / 2.0 ** (bits - 1))
    g_shift = _f32(1.0 / 2.0**7)
    s_embed, s_tok = _f32(artifact["embed_scale"]), _f32(artifact["tokens_scale"])
    t = {
        "config": cfg,
        "input_scale": _f32(artifact["input_scale"]).to(device),
        "patch_embed": carry_linear(artifact["patch_embed"], device, s_embed),
        "cls_q": _f32(artifact["cls_q"]).to(device),
        "embed_to_tokens": ops.div(s_embed, s_tok).to(device),
        "pos": torch.round(_f32(artifact["pos_q"]) * ops.div(_f32(artifact["pos_scale"]), s_tok)).to(device),
    }
    blocks, s_x = [], s_tok
    for blk in artifact["blocks"]:
        s = {k: _f32(v) for k, v in blk.items() if k.startswith("s_")}
        sa1 = s["s_attn_qact1"]
        blocks.append({
            "norm1": carry_norm(blk["norm1"], device, s["s_qact1"]),
            "qkv": carry_linear(blk["qkv"], device, sa1),
            "r1": ops.div((sa1 * sa1) * qk_scale, s["s_attn_sm_in"]).to(device),
            "sm_scale": s["s_attn_sm_in"].to(device),
            "r_out": ops.div(s_sm * sa1, s["s_attn_out"]).to(device),
            "proj": carry_linear(blk["proj"], device, s["s_attn_proj"]),
            "res1": (ops.div(s["s_attn_proj"], s["s_res1"]).to(device), ops.div(s_x, s["s_res1"]).to(device)),
            "norm2": carry_norm(blk["norm2"], device, s["s_qact3"]),
            "fc1": carry_linear(blk["fc1"], device, s["s_gelu_in"]),
            "gelu_scale": s["s_gelu_in"].to(device),
            "gelu_ratio": ops.div(s["s_gelu_in"] * g_shift, s["s_gelu_out"]).to(device),
            "fc2": carry_linear(blk["fc2"], device, s["s_mlp_out"]),
            "res2": (ops.div(s["s_mlp_out"], s["s_res2"]).to(device), ops.div(s["s_res1"], s["s_res2"]).to(device)),
        })
        s_x = s["s_res2"]
    t["blocks"] = blocks
    t["norm"] = carry_norm(artifact["norm"], device, _f32(artifact["head_in_scale"]))
    t["head"] = carry_linear(artifact["head"], device)
    return t


def residual(branch: torch.Tensor, skip: torch.Tensor, ratios) -> torch.Tensor:
    """The dual-scale 16-bit residual merge into the int16 stream."""
    merged = torch.round(branch * ratios[0]) + torch.round(skip.to(torch.float32) * ratios[1])
    return torch.clamp(merged, *ops.INT16).to(torch.int16)


def attention(q, k, v, r1, sm_scale, r_out, bits: int) -> torch.Tensor:
    """int8 Q·Kᵀ → requant → Shiftmax → @V → requant, on (G, N, hd)."""
    a8 = ops.requant(ops.exact_matmul(q, k.transpose(-1, -2)).to(torch.int32), r1, *ops.INT8)
    sm = ops.shiftmax(a8, sm_scale, out_bits=bits)
    return ops.requant(ops.exact_matmul(sm, v).to(torch.int32), r_out, *ops.INT8).to(torch.int8)


def mlp_half(h: torch.Tensor, blk: dict, stable: bool, weight_bits: int) -> torch.Tensor:
    """norm2 → fc1 → ShiftGELU → requant → fc2 → the second residual, on
    the (M, C) int16 stream."""
    y = ops.layernorm_requant(h, blk["norm2"]["bias_int"], blk["norm2"]["ratio"])
    acc = linear(y, blk["fc1"], weight_bits)
    g = ops.shiftgelu(ops.requant(acc, blk["fc1"]["ratio"], *ops.INT8), blk["gelu_scale"], stable)
    g8 = ops.requant(g, blk["gelu_ratio"], *ops.INT8)
    m = ops.requant(linear(g8, blk["fc2"], weight_bits), blk["fc2"]["ratio"], *ops.INT16)
    return residual(m, h, blk["res2"])


def qkv_split(y: torch.Tensor, qkv: dict, B: int, heads: int, weight_bits: int):
    """qkv GEMM → requant → (3, B·heads, N, hd) int8."""
    z = ops.requant(linear(y, qkv, weight_bits), qkv["ratio"], *ops.INT8).to(torch.int8)
    N, hd = y.shape[0] // B, z.shape[1] // (3 * heads)
    return z.reshape(B, N, 3, heads, hd).permute(2, 0, 3, 1, 4).reshape(3, B * heads, N, hd)


@torch.no_grad()
def forward(t: dict, images: torch.Tensor, weight_bits: int = 8) -> torch.Tensor:
    """Logits of NHWC float32 ``images`` (on ``t``'s device)."""
    cfg = t["config"]
    D, H, p, gh, _, _ = _geometry(cfg)
    B = images.shape[0]
    x = torch.clamp(torch.round(ops.div(images, t["input_scale"])), *ops.INT8)
    x = x.reshape(B, gh, p, gh, p, 3).permute(0, 1, 3, 2, 4, 5).reshape(B * gh * gh, p * p * 3)
    pe = t["patch_embed"]
    x = ops.requant(linear(x, pe, weight_bits), pe["ratio"], *ops.INT16).reshape(B, gh * gh, D)
    x = torch.cat([t["cls_q"].expand(B, 1, D), x], dim=1)
    x = torch.clamp(torch.round(x * t["embed_to_tokens"]) + t["pos"], *ops.INT16).to(torch.int16)
    N = x.shape[1]
    for blk in t["blocks"]:
        y = ops.layernorm_requant(x.reshape(B * N, D), blk["norm1"]["bias_int"], blk["norm1"]["ratio"])
        q, k, v = qkv_split(y, blk["qkv"], B, H, weight_bits)
        ctx = attention(q, k, v, blk["r1"], blk["sm_scale"], blk["r_out"], int(cfg["softmax_bits"]))
        ctx = ctx.reshape(B, H, N, -1).permute(0, 2, 1, 3).reshape(B * N, D)
        branch = ops.requant(linear(ctx, blk["proj"], weight_bits), blk["proj"]["ratio"], *ops.INT16)
        h = residual(branch, x.reshape(B * N, D), blk["res1"])
        x = mlp_half(h, blk, bool(cfg["gelu_stable"]), weight_bits).reshape(B, N, D)
    y = ops.layernorm_requant(x[:, 0], t["norm"]["bias_int"], t["norm"]["ratio"])
    head = t["head"]
    return linear(y, head, weight_bits).to(torch.float32) * head["out_scale"]
