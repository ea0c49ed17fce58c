"""The integer-only ViT (I-ViT) over rows longer than 256 tokens, in plain
torch: a ViT at its fine-tuning resolution, such as ViT-L/16 at 384²
(577 tokens).

Everything but Shiftmax's row sum is ``reference/vit.py`` and
``reference/intops.py``: the seeded weights (``make_params``), the
artifact's carried ratios (``carry``), the requants, ShiftGELU,
I-LayerNorm and the residuals. ``intops.shiftmax`` sums a row through
two limbs split at 2^16, which is exact only up to 256 columns, and
refuses longer rows; here Shiftmax sums them by the spec's long-row tree
(``tree_row_sum``). So the calibration pass and the forward are
``vit.py``'s, written out again around that one change, and the
attention runs its cells in blocks to bound the float64 scores' memory.

Integer products run in float64 (exact) and the rest in float32 on
integer-valued carriers; TF32 stays off wherever float32 is multiplied.
Nothing here comes from the program under test.
"""

from __future__ import annotations

import numpy as np
import torch

from . import intops as ops
from . import vit
from .vit import carry, make_params  # noqa: F401  (the family's interface)

_CELLS = 256  # attention cells (batch·head) a block of the plain attention
MAX_ROW = 4096


def tree_row_sum(exp_int: torch.Tensor) -> torch.Tensor:
    """Row sum of shift-exp values over the last axis by the spec's
    long-row tree (``ivit_tpu/ops/shiftmax.py:_exact_sum_lastdim``): each
    value e ≤ 2^31 split into three limbs at 2^12, e = l2·2^24 + l1·2^12 +
    l0; each limb summed over the row in float32, exact in any order
    (l2 ≤ 2^7 and l1, l0 < 2^12, so every partial sum stays below 2^24 for
    rows of at most 4096); then the fixed tree (s2·2^12 + s1)·2^12 + s0 in
    float32, which rounds at each of its two adds.

    Departures from the paper (I-ViT, arXiv:2207.01405, whose Shiftmax
    sums the shift-exps exactly in integers): the sum is rounded to
    float32 by this tree, and the caller clips it to [1, 2^31] before the
    division; ``2^31 − 1`` in the factor ⌊(2^31 − 1)/Σ⌋ is itself float32,
    so it reads 2^31. Rows of at most 256 take intops' two-limb sum, which
    rounds once; the tree rounds twice."""
    if exp_int.shape[-1] > MAX_ROW:
        raise ValueError(f"the long-row tree takes rows of at most {MAX_ROW}")
    l2 = torch.floor(exp_int * (1.0 / 2.0**24))
    rem = exp_int - l2 * 2.0**24
    l1 = torch.floor(rem * (1.0 / 2.0**12))
    l0 = rem - l1 * 2.0**12
    s2, s1, s0 = (limb.sum(-1, keepdim=True) for limb in (l2, l1, l0))
    return (s2 * 2.0**12 + s1) * 2.0**12 + s0


def shiftmax(q: torch.Tensor, scale: torch.Tensor, out_bits: int = 8, n: int = ops.SHIFTMAX_N) -> torch.Tensor:
    """``intops.shiftmax`` with the row sum of ``tree_row_sum`` at rows
    longer than 256."""
    if q.shape[-1] <= 256:
        return ops.shiftmax(q, scale, out_bits, n)
    q = q - torch.amax(q, dim=-1, keepdim=True)
    exp_int = ops.int_exp_shift(q, scale, n)
    exp_sum = torch.clamp(tree_row_sum(exp_int), 1.0, ops.I32_MAX)
    factor = torch.floor(ops.div(ops.I32_MAX, exp_sum)) * (1.0 / 2.0 ** (32 - out_bits))
    return torch.floor(exp_int * factor)


def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def calibrate(cfg: dict, params: dict, images: torch.Tensor) -> dict:
    """``vit.calibrate`` with this family's Shiftmax: the frozen artifact
    of ``params`` with scales set on ``images`` (NHWC float32)."""
    _no_tf32()
    D, H, p, gh, hd, _ = vit._geometry(cfg)
    c = vit.Calibration(images.device)
    a: dict = {"config": dict(cfg)}
    B = images.shape[0]
    s_in = c.act(images, 8, "input_scale", a)
    x = ops.quantize(images, s_in, 8)
    x = x.reshape(B, gh, p, gh, p, 3).permute(0, 1, 3, 2, 4, 5).reshape(B * gh * gh, p * p * 3)
    acc, s_acc = c.linear(x, params["patch_embed"], s_in, "patch_embed", a)
    s_embed = c.act(acc * s_acc, 16, "embed_scale", a)
    x = ops.requantize(acc, s_acc, s_embed, 16).reshape(B, gh * gh, D)
    cls_q = torch.round(ops.div(params["cls_token"], s_embed))
    a["cls_q"] = vit._np(cls_q, np.float32)
    x = torch.cat([cls_q.expand(B, 1, D), x], dim=1)
    s_pos = c.act(params["pos_embed"], 16, "pos_scale", a)
    pos_q = ops.quantize(params["pos_embed"], s_pos, 16)
    a["pos_q"] = vit._np(pos_q, np.float32)
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
        sm = shiftmax(ops.requantize(attn, s_attn, ssm, 8), ssm, out_bits=int(cfg["softmax_bits"]))
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
    a["head"] = vit.freeze_linear(*params["head"], s_head)
    return a


def attention(q, k, v, r1, sm_scale, r_out, bits: int) -> torch.Tensor:
    """int8 Q·Kᵀ → requant → Shiftmax → @V → requant, on (G, N, hd), in
    blocks of ``_CELLS`` cells."""
    out = []
    for i in range(0, q.shape[0], _CELLS):
        qi, ki, vi = q[i:i + _CELLS], k[i:i + _CELLS], v[i:i + _CELLS]
        a8 = ops.requant(ops.exact_matmul(qi, ki.transpose(-1, -2)).to(torch.int32), r1, *ops.INT8)
        sm = shiftmax(a8, sm_scale, out_bits=bits)
        out.append(ops.requant(ops.exact_matmul(sm, vi).to(torch.int32), r_out, *ops.INT8).to(torch.int8))
    return torch.cat(out)


@torch.no_grad()
def forward(t: dict, images: torch.Tensor, weight_bits: int = 8) -> torch.Tensor:
    """``vit.forward`` with this family's attention: logits of NHWC
    float32 ``images`` (on ``t``'s device)."""
    _no_tf32()
    cfg = t["config"]
    D, H, p, gh, _, _ = vit._geometry(cfg)
    B = images.shape[0]
    x = torch.clamp(torch.round(ops.div(images, t["input_scale"])), *ops.INT8)
    x = x.reshape(B, gh, p, gh, p, 3).permute(0, 1, 3, 2, 4, 5).reshape(B * gh * gh, p * p * 3)
    pe = t["patch_embed"]
    x = ops.requant(vit.linear(x, pe, weight_bits), pe["ratio"], *ops.INT16).reshape(B, gh * gh, D)
    x = torch.cat([t["cls_q"].expand(B, 1, D), x], dim=1)
    x = torch.clamp(torch.round(x * t["embed_to_tokens"]) + t["pos"], *ops.INT16).to(torch.int16)
    N = x.shape[1]
    for blk in t["blocks"]:
        y = ops.layernorm_requant(x.reshape(B * N, D), blk["norm1"]["bias_int"], blk["norm1"]["ratio"])
        q, k, v = vit.qkv_split(y, blk["qkv"], B, H, weight_bits)
        ctx = attention(q, k, v, blk["r1"], blk["sm_scale"], blk["r_out"], int(cfg["softmax_bits"]))
        ctx = ctx.reshape(B, H, N, -1).permute(0, 2, 1, 3).reshape(B * N, D)
        branch = ops.requant(vit.linear(ctx, blk["proj"], weight_bits), blk["proj"]["ratio"], *ops.INT16)
        h = vit.residual(branch, x.reshape(B * N, D), blk["res1"])
        x = vit.mlp_half(h, blk, bool(cfg["gelu_stable"]), weight_bits).reshape(B, N, D)
    y = ops.layernorm_requant(x[:, 0], t["norm"]["bias_int"], t["norm"]["ratio"])
    head = t["head"]
    return vit.linear(y, head, weight_bits).to(torch.float32) * head["out_scale"]
