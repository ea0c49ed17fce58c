"""The integer-only Swin Transformer in plain torch: seeded weights, the
calibration that freezes them into an artifact, and the integer forward
that judges what the served engine returns.

The same three steps as ``reference/vit.py``, with Swin's geometry
(Liu et al., arXiv:2103.14030): patch embed and an int16 patch norm,
shifted-window blocks (a cyclic roll, window partition, int8 Q·Kᵀ →
requant, the relative-position bias quantized on its own and merged at
the bias scale, the shifted-window mask added, 8-bit Shiftmax, @V,
requant, the window reverse and the roll back), bias-free patch
merging, the final norm, an exact token mean and the head. Nothing here
comes from the program under test.
"""

from __future__ import annotations

import numpy as np
import torch

from . import intops as ops
from .vit import Calibration, _f32, _np, carry_linear, carry_norm, freeze_linear, linear, mlp_half, qkv_split, residual
from .weights import Draws, linear_size

_CALIB_IMAGES = 2


def stage_geometry(cfg: dict, stage: int, block: int) -> tuple[int, int, int]:
    """(grid side, window, cyclic shift) of a block: odd blocks shift by
    half a window unless one window covers the grid."""
    res = cfg["img_size"] // cfg["patch_size"] // 2**stage
    ws = min(cfg["window_size"], res)
    shift = 0 if block % 2 == 0 or res <= cfg["window_size"] else cfg["window_size"] // 2
    return res, ws, shift


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) → (B·nW, ws·ws, C)."""
    B, H, W, C = x.shape
    return x.reshape(B, H // ws, ws, W // ws, ws, C).permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, C)


def window_reverse(x: torch.Tensor, ws: int, res: int) -> torch.Tensor:
    """(B·nW, ws·ws, C) → (B, res, res, C)."""
    C = x.shape[-1]
    B = x.shape[0] // ((res // ws) ** 2)
    return x.reshape(B, res // ws, res // ws, ws, ws, C).permute(0, 1, 3, 2, 4, 5).reshape(B, res, res, C)


def relative_position_index(ws: int) -> np.ndarray:
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0) + (ws - 1)
    return (rel[..., 0] * (2 * ws - 1) + rel[..., 1]).astype(np.int64)


def gather_bias(table_q: torch.Tensor, ws: int) -> torch.Tensor:
    """The (H, N, N) bias of a window from the (T, H) table."""
    N, H = ws * ws, table_q.shape[1]
    idx = torch.from_numpy(relative_position_index(ws).reshape(-1)).to(table_q.device)
    return table_q[idx].reshape(N, N, H).permute(2, 0, 1)


def shift_mask(res: int, ws: int, shift: int) -> np.ndarray | None:
    """The shifted-window mask (nW, N, N) of {0, −100}; None unshifted."""
    if shift == 0:
        return None
    img = np.zeros((res, res), np.float32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[hs, wsl] = cnt
            cnt += 1
    win = img.reshape(res // ws, ws, res // ws, ws).transpose(0, 2, 1, 3).reshape(-1, ws * ws)
    return np.where(win[:, None, :] - win[:, :, None] != 0, -100.0, 0.0).astype(np.float32)


def merge_gather(x: torch.Tensor, res: int) -> torch.Tensor:
    """The 2×2 neighbourhood concat of (B, res², C) into (B, res²/4, 4C)."""
    B, L, C = x.shape
    g = x.reshape(B, res, res, C)
    q = torch.cat([g[:, 0::2, 0::2], g[:, 1::2, 0::2], g[:, 0::2, 1::2], g[:, 1::2, 1::2]], -1)
    return q.reshape(B, L // 4, 4 * C)


def _stages(cfg: dict):
    """(dim, heads, hidden, window, depth) of each stage."""
    out = []
    for i, (depth, heads) in enumerate(zip(cfg["depths"], cfg["num_heads"])):
        dim = cfg["embed_dim"] * 2**i
        out.append((dim, heads, int(dim * cfg["mlp_ratio"]), stage_geometry(cfg, i, 0)[1], depth))
    return out


def param_count(cfg: dict) -> int:
    D, p = cfg["embed_dim"], cfg["patch_size"]
    total = linear_size(p * p * 3, D) + 2 * D
    stages = _stages(cfg)
    for i, (dim, heads, hidden, ws, depth) in enumerate(stages):
        block = (4 * dim + (2 * ws - 1) ** 2 * heads + linear_size(dim, 3 * dim) + linear_size(dim, dim)
                 + linear_size(dim, hidden) + linear_size(hidden, dim))
        total += depth * block
        if i < len(stages) - 1:
            total += 8 * dim + 4 * dim * 2 * dim
    nf = stages[-1][0]
    return total + 2 * nf + linear_size(nf, cfg["num_classes"])


def make_params(cfg: dict, generator: torch.Generator, device) -> dict:
    """The float parameters of ``cfg``'s model, in graph order."""
    D, p = cfg["embed_dim"], cfg["patch_size"]
    d = Draws(param_count(cfg), generator, device)
    params = {"patch_embed": d.linear(p * p * 3, D), "patch_norm": d.norm(D), "stages": []}
    stages = _stages(cfg)
    for i, (dim, heads, hidden, ws, depth) in enumerate(stages):
        blocks = [
            {"norm1": d.norm(dim), "table": d.trunc_normal(((2 * ws - 1) ** 2, heads)),
             "qkv": d.linear(dim, 3 * dim), "proj": d.linear(dim, dim),
             "norm2": d.norm(dim), "fc1": d.linear(dim, hidden), "fc2": d.linear(hidden, dim)}
            for _ in range(depth)
        ]
        merging = None
        if i < len(stages) - 1:
            merging = {"norm": d.norm(4 * dim), "reduction": d.linear(4 * dim, 2 * dim, bias=False)}
        params["stages"].append((blocks, merging))
    nf = stages[-1][0]
    params["norm"] = d.norm(nf)
    params["head"] = d.linear(nf, cfg["num_classes"])
    return params


def _window_attention_half(c: Calibration, x, s_x, bp, blk, B):
    res, ws, shift, H = blk["res"], blk["ws"], blk["shift"], blk["heads"]
    L, C = x.shape[1], x.shape[2]
    hd, N, nW = C // H, ws * ws, (res // ws) ** 2
    y, s_y = c.norm(x, bp["norm1"], "norm1", blk)
    s1 = c.act(y * s_y, 8, "s_qact1", blk)
    y = ops.requantize(y, s_y, s1, 8).reshape(B, res, res, C)
    if shift:
        y = torch.roll(y, (-shift, -shift), dims=(1, 2))
    xw = window_partition(y, ws)
    Bw = xw.shape[0]
    acc, s_acc = c.linear(xw.reshape(-1, C), bp["qkv"], s1, "qkv", blk)
    sa1 = c.act(acc * s_acc, 8, "s_attn_qact1", blk)
    z = ops.requantize(acc, s_acc, sa1, 8).reshape(Bw, N, 3, H, hd).permute(2, 0, 3, 1, 4)
    attn = ops.exact_matmul(z[0], z[1].transpose(-1, -2)).to(torch.float32)
    s_attn = (sa1 * sa1) * np.float32(hd**-0.5)
    s_a1 = c.act(attn * s_attn, 8, "s_attn1", blk)
    a8 = ops.requantize(attn, s_attn, s_a1, 8)
    table = bp["table"]
    s_table = ops.symmetric_scale(table.min(), table.max(), 8)
    bias_q = gather_bias(ops.quantize(table, s_table, 8), ws)
    sb = c.act(a8 * s_a1 + bias_q * s_table, 8, "s_bias", blk)
    merged = ops.requantize(a8, s_a1, sb, 8, bias_q, s_table)
    blk["bias_req"] = _np(torch.round(bias_q * ops.div(s_table, sb)), np.float32)
    mask = shift_mask(res, ws, shift)
    blk["mask_int"] = None
    if mask is not None:
        mask_int = ops.div(torch.from_numpy(mask).to(sb.device), sb)
        blk["mask_int"] = _np(mask_int, np.float32)
        merged = (merged.reshape(Bw // nW, nW, H, N, N) + mask_int[None, :, None]).reshape(Bw, H, N, N)
    sm = ops.shiftmax(merged, sb, out_bits=8)
    ctx = ops.exact_matmul(sm, z[2]).to(torch.float32)
    s_ctx = ops.scalar(1.0 / 2.0**7, sb.device) * sa1
    so = c.act(ctx * s_ctx, 8, "s_attn_out", blk)
    ctx = ops.requantize(ctx, s_ctx, so, 8).permute(0, 2, 1, 3).reshape(-1, C)
    acc, s_acc = c.linear(ctx, bp["proj"], so, "proj", blk)
    sap = c.act(acc * s_acc, 16, "s_attn_proj", blk)
    branch = window_reverse(ops.requantize(acc, s_acc, sap, 16).reshape(Bw, N, C), ws, res)
    if shift:
        branch = torch.roll(branch, (shift, shift), dims=(1, 2))
    branch = branch.reshape(B, L, C)
    sr1 = c.act(branch * sap + x * s_x, 16, "s_res1", blk)
    return ops.requantize(branch, sap, sr1, 16, x, s_x), sr1


def token_sum_mean(y: torch.Tensor, inv_tokens: torch.Tensor) -> torch.Tensor:
    """The mean over tokens of integer-valued (B, L, C): the exact sum
    times float32(1/L)."""
    return y.to(torch.int32).sum(1, dtype=torch.int32).to(torch.float32) * inv_tokens


def calibrate(cfg: dict, params: dict, images: torch.Tensor) -> dict:
    """The frozen artifact of ``params`` with scales set on ``images``."""
    D, p, img = cfg["embed_dim"], cfg["patch_size"], cfg["img_size"]
    c = Calibration(images.device)
    a: dict = {"config": dict(cfg)}
    B, gh = images.shape[0], img // p
    s_in = c.act(images, 8, "input_scale", a)
    x = ops.quantize(images, s_in, 8)
    x = x.reshape(B, gh, p, gh, p, 3).permute(0, 1, 3, 2, 4, 5).reshape(B * gh * gh, p * p * 3)
    acc, s_acc = c.linear(x, params["patch_embed"], s_in, "patch_embed", a)
    s_bn = c.act(acc * s_acc, 8, "s_before_norm", a)
    y, s_y = c.norm(ops.requantize(acc, s_acc, s_bn, 8), params["patch_norm"], "patch_norm", a)
    s_e = c.act(y * s_y, 16, "embed_scale", a)
    x = ops.requantize(y, s_y, s_e, 16)
    s_x = c.act(x * s_e, 16, "tokens_scale", a)
    x = ops.requantize(x, s_e, s_x, 16).reshape(B, gh * gh, D)

    stages = []
    for i, (blocks_params, merging) in enumerate(params["stages"]):
        blocks = []
        for j, bp in enumerate(blocks_params):
            res, ws, shift = stage_geometry(cfg, i, j)
            blk: dict = {"res": res, "ws": ws, "shift": shift, "heads": cfg["num_heads"][i]}
            x, s_x = _window_attention_half(c, x, s_x, bp, blk, B)
            x, s_x = c.mlp_half(x, s_x, bp, blk, bool(cfg["gelu_stable"]))
            blocks.append(blk)
        stage = {"blocks": blocks}
        if merging is not None:
            res, L, C = stage_geometry(cfg, i, 0)[0], x.shape[1], x.shape[2]
            ds: dict = {"res": res, "dim": C}
            y, s_y = c.norm(merge_gather(x, res), merging["norm"], "norm", ds)
            s_dq = c.act(y * s_y, 8, "s_qact1", ds)
            acc, s_acc = c.linear(ops.requantize(y, s_y, s_dq, 8).reshape(-1, 4 * C),
                                  merging["reduction"], s_dq, "reduction", ds)
            s_x = c.act(acc * s_acc, 8, "s_out", ds)
            x = ops.requantize(acc, s_acc, s_x, 8).reshape(B, L // 4, 2 * C)
            stage["downsample"] = ds
        stages.append(stage)
    a["stages"] = stages

    y, s_y = c.norm(x, params["norm"], "norm", a)
    s2 = c.act(y * s_y, 8, "s_qact2", a)
    y8 = ops.requantize(y, s_y, s2, 8)
    pooled = y8.sum(1) * ops.div(1.0, ops.scalar(float(y8.shape[1]), y8.device))
    s3 = c.act(pooled * s2, 8, "s_qact3", a)
    a["head"] = freeze_linear(*params["head"], s3)
    return a


def carry(artifact: dict, device) -> dict:
    """The artifact's tensors on ``device`` with every ratio divided once
    in float32 on the host."""
    cfg = dict(artifact["config"])
    s_sm = _f32(1.0 / 2.0**7)  # the 8-bit probability scale and the ShiftGELU shift
    s_bn, s_embed, s_tok = (_f32(artifact[k]) for k in ("s_before_norm", "embed_scale", "tokens_scale"))
    t = {
        "config": cfg,
        "input_scale": _f32(artifact["input_scale"]).to(device),
        "patch_embed": carry_linear(artifact["patch_embed"], device, s_bn),
        "patch_norm": carry_norm(artifact["patch_norm"], device, s_embed),
        "embed_to_tokens": ops.div(s_embed, s_tok).to(device),
    }
    stages, s_x = [], s_tok
    for stage in artifact["stages"]:
        blocks = []
        for blk in stage["blocks"]:
            s = {k: _f32(v) for k, v in blk.items() if k.startswith("s_")}
            hd = np.shape(blk["qkv"]["w"])[0] // blk["heads"]
            sa1, s1, sb = s["s_attn_qact1"], s["s_attn1"], s["s_bias"]
            s_attn = (sa1 * sa1) * _f32(float(hd) ** -0.5)
            blocks.append({
                "res": blk["res"], "ws": blk["ws"], "shift": blk["shift"], "heads": blk["heads"],
                "norm1": carry_norm(blk["norm1"], device, s["s_qact1"]),
                "qkv": carry_linear(blk["qkv"], device, sa1),
                "bias": _f32(blk["bias_req"]).to(device),
                "mask": None if blk["mask_int"] is None else _f32(blk["mask_int"]).to(device),
                "r1": ops.div(s_attn, s1).to(device),
                "rb": ops.div(s1, sb).to(device),
                "sm_scale": sb.to(device),
                "r_out": ops.div(s_sm * sa1, s["s_attn_out"]).to(device),
                "proj": carry_linear(blk["proj"], device, s["s_attn_proj"]),
                "res1": (ops.div(s["s_attn_proj"], s["s_res1"]).to(device), ops.div(s_x, s["s_res1"]).to(device)),
                "norm2": carry_norm(blk["norm2"], device, s["s_qact3"]),
                "fc1": carry_linear(blk["fc1"], device, s["s_gelu_in"]),
                "gelu_scale": s["s_gelu_in"].to(device),
                "gelu_ratio": ops.div(s["s_gelu_in"] * s_sm, s["s_gelu_out"]).to(device),
                "fc2": carry_linear(blk["fc2"], device, s["s_mlp_out"]),
                "res2": (ops.div(s["s_mlp_out"], s["s_res2"]).to(device), ops.div(s["s_res1"], s["s_res2"]).to(device)),
            })
            s_x = s["s_res2"]
        carried = {"blocks": blocks}
        if "downsample" in stage:
            ds = stage["downsample"]
            s_out = _f32(ds["s_out"])
            carried["downsample"] = {"res": ds["res"], "norm": carry_norm(ds["norm"], device, _f32(ds["s_qact1"])),
                                     "reduction": carry_linear(ds["reduction"], device, s_out)}
            s_x = s_out
        stages.append(carried)
    t["stages"] = stages
    s_qact2 = _f32(artifact["s_qact2"])
    t["norm"] = carry_norm(artifact["norm"], device, s_qact2)
    t["pool_ratio"] = ops.div(s_qact2, _f32(artifact["s_qact3"])).to(device)
    tokens = stage_geometry(cfg, len(cfg["depths"]) - 1, 0)[0] ** 2
    t["inv_tokens"] = ops.div(_f32(1.0), _f32(float(tokens))).to(device)
    t["head"] = carry_linear(artifact["head"], device)
    return t


def window_attention(q, k, v, blk: dict) -> torch.Tensor:
    """int8 Q·Kᵀ → requant → bias merge → mask → Shiftmax → @V → requant
    on (B·nW·H, N, hd), the head innermost."""
    G, N, _ = q.shape
    H = blk["heads"]
    a8 = ops.requant(ops.exact_matmul(q, k.transpose(-1, -2)).to(torch.int32), blk["r1"], *ops.INT8)
    z = torch.clamp(torch.round(a8 * blk["rb"]).view(G // H, H, N, N) + blk["bias"], *ops.INT8)
    if blk["mask"] is not None:
        nW = blk["mask"].shape[0]
        z = z.view(G // (nW * H), nW, H, N, N) + blk["mask"][None, :, None]
    sm = ops.shiftmax(z.reshape(G, N, N), blk["sm_scale"], out_bits=8)
    return ops.requant(ops.exact_matmul(sm, v).to(torch.int32), blk["r_out"], *ops.INT8).to(torch.int8)


def swin_block(x: torch.Tensor, blk: dict, stable: bool, weight_bits: int) -> torch.Tensor:
    B, L, C = x.shape
    res, ws, shift, H = blk["res"], blk["ws"], blk["shift"], blk["heads"]
    y = ops.layernorm_requant(x.reshape(B * L, C), blk["norm1"]["bias_int"], blk["norm1"]["ratio"])
    y = y.view(B, res, res, C)
    if shift:
        y = torch.roll(y, (-shift, -shift), dims=(1, 2))
    xw = window_partition(y, ws)
    q, k, v = qkv_split(xw.reshape(-1, C), blk["qkv"], xw.shape[0], H, weight_bits)
    ctx = window_attention(q, k, v, blk)
    G, N, hd = ctx.shape
    ctx = ctx.view(G // H, H, N, hd).permute(0, 2, 1, 3).reshape(-1, H * hd)
    branch = ops.requant(linear(ctx, blk["proj"], weight_bits), blk["proj"]["ratio"], *ops.INT16)
    g = window_reverse(branch.view(-1, N, C), ws, res)
    if shift:
        g = torch.roll(g, (shift, shift), dims=(1, 2))
    h = residual(g.reshape(B * L, C), x.reshape(B * L, C), blk["res1"])
    return mlp_half(h, blk, stable, weight_bits).view(B, L, C)


@torch.no_grad()
def forward(t: dict, images: torch.Tensor, weight_bits: int = 8) -> torch.Tensor:
    """Logits of NHWC float32 ``images`` (on ``t``'s device)."""
    cfg = t["config"]
    p, D = cfg["patch_size"], cfg["embed_dim"]
    gh = cfg["img_size"] // p
    B = images.shape[0]
    stable = bool(cfg["gelu_stable"])
    x = torch.clamp(torch.round(ops.div(images, t["input_scale"])), *ops.INT8)
    x = x.reshape(B, gh, p, gh, p, 3).permute(0, 1, 3, 2, 4, 5).reshape(B * gh * gh, p * p * 3)
    pe, pn = t["patch_embed"], t["patch_norm"]
    x = ops.requant(linear(x, pe, weight_bits), pe["ratio"], *ops.INT8)
    x = ops.requant(ops.layernorm_int(x) + pn["bias_int"], pn["ratio"], *ops.INT16)
    x = torch.clamp(torch.round(x * t["embed_to_tokens"]), *ops.INT16).to(torch.int16).reshape(B, gh * gh, D)
    for stage in t["stages"]:
        for blk in stage["blocks"]:
            x = swin_block(x, blk, stable, weight_bits)
        if "downsample" in stage:
            ds = stage["downsample"]
            B, L, C = x.shape
            y = ops.layernorm_requant(merge_gather(x, ds["res"]).reshape(-1, 4 * C), ds["norm"]["bias_int"],
                                      ds["norm"]["ratio"])
            red = ds["reduction"]
            x = ops.requant(linear(y, red, weight_bits), red["ratio"], *ops.INT8).to(torch.int16).view(B, L // 4, 2 * C)
    B, L, C = x.shape
    y = ops.layernorm_requant(x.reshape(B * L, C), t["norm"]["bias_int"], t["norm"]["ratio"]).view(B, L, C)
    y8 = ops.requant(token_sum_mean(y, t["inv_tokens"]), t["pool_ratio"], *ops.INT8)
    head = t["head"]
    return linear(y8, head, weight_bits).to(torch.float32) * head["out_scale"]
