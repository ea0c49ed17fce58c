"""A seeded, full-width stand-in for a frozen Swin artifact.

The Swin counterpart of ``deploy/synthetic.py``, built with numpy and
torch alone, so a machine without JAX can serve a Swin of real width:

* weights and relative-position bias tables are truncated-normal with
  std 0.02 (``ivit_tpu/nn/quant.py:124``, ``ivit_tpu/models/swin.py:104-109``);
  biases and LayerNorm γ−1, β are small and random;
* every activation scale comes from one calibration pass in graph order
  on two seeded normal images, with the ``_act_scale`` rule at the points
  of the Swin model's ``QuantAct``s (``ivit_tpu/models/swin.py:111-163``,
  ``:201-247``, ``:270-273``, ``:304-371``): ``qact_table`` on the table,
  ``qact2`` on the merged score plus the bias identity, the 16-bit
  residual acts with their identities;
* then the freeze of ``ivit_tpu/deploy/swin_engine.py:freeze_swin``:
  ``tq = clip(round(table/s_table))``, ``bias_req = round(tq[idx] ·
  f32(s_table/s_bias))`` shaped (H, N, N), ``mask_int = f32(mask/s_bias)``,
  by the helpers ``freeze_swin`` calls (``deploy.swin_engine.window_bias``
  and ``window_mask``).

The result has exactly ``freeze_swin``'s keys, dtypes, shapes and
geometry (``deploy.swin_artifact.validate_swin_artifact``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import quantize
from ..kernels.window_attention_fused import window_attention_probabilities
from ..models import create_config
from ..models.swin import gather_bias, stage_geometry, token_mean, window_partition, window_reverse
from ..ops import requantize, shiftmax
from .convert import freeze_linear
from .swin_artifact import swin_artifact_to_torch, validate_swin_artifact
from .swin_engine import patch_embed, swin_trunk, window_attention_inputs, window_bias, window_mask
from .synthetic import (
    _CALIB_IMAGES,
    _act_scale,
    _calib_linear,
    _calib_mlp_half,
    _calib_norm,
    _Init,
    _matmul_exact,
    _np,
    _qact,
)


def _window_attention_half(x, s_x, bp, blk, geometry, B):
    """norm1 → shift → windows → attention with the frozen bias and mask →
    proj → reverse → the first residual, on the stream ``x`` (B, L, C) at
    ``s_x``; scales and frozen tensors go into ``blk``. Returns the new
    stream and its scale."""
    res, ws, shift = geometry
    L, C = x.shape[1], x.shape[2]
    H = blk["heads"]
    hd, N, nW = C // H, ws * ws, (res // ws) ** 2
    y, s_y = _calib_norm(x, bp["norm1"], "norm1", blk)
    s1 = _qact(y * s_y, 8, "s_qact1", blk)
    y = requantize(y, s_y, s1, 8).reshape(B, res, res, C)
    if shift:
        y = torch.roll(y, (-shift, -shift), dims=(1, 2))
    xw = window_partition(y, ws)
    Bw = xw.shape[0]
    acc, s_acc = _calib_linear(xw.reshape(-1, C), bp["qkv"], s1, "qkv", blk)
    sa1 = _qact(acc * s_acc, 8, "s_attn_qact1", blk)
    z = requantize(acc, s_acc, sa1, 8).reshape(Bw, N, 3, H, hd).permute(2, 0, 3, 1, 4)
    q, k, v = z[0], z[1], z[2]
    attn = _matmul_exact(q, k.transpose(-1, -2))  # (Bw, H, N, N)
    s_attn = (sa1 * sa1) * np.float32(hd**-0.5)
    s_a1 = _qact(attn * s_attn, 8, "s_attn1", blk)
    a8 = requantize(attn, s_attn, s_a1, 8)
    # the relative-position bias: qact_table, gathered, merged by qact2
    table = bp["table"]
    s_table = _act_scale(table, 8)
    bias_q = gather_bias(quantize(table, s_table, 8), ws)
    sb = _qact(a8 * s_a1 + bias_q * s_table, 8, "s_bias", blk)
    merged = requantize(a8, s_a1, sb, 8, bias_q, s_table)
    blk["bias_req"] = _np(window_bias(table, s_table, sb, ws), np.float32)
    mask_int = window_mask(res, ws, shift, sb)
    blk["mask_int"] = None
    if mask_int is not None:
        blk["mask_int"] = _np(mask_int, np.float32)
        merged = (merged.reshape(Bw // nW, nW, H, N, N) + mask_int[None, :, None]).reshape(Bw, H, N, N)
    sm, s_sm = shiftmax(merged, sb, out_bits=8)
    ctx = _matmul_exact(sm, v)
    s_ctx = s_sm * sa1
    so = _qact(ctx * s_ctx, 8, "s_attn_out", blk)
    ctx = requantize(ctx, s_ctx, so, 8).permute(0, 2, 1, 3).reshape(-1, C)
    acc, s_acc = _calib_linear(ctx, bp["proj"], so, "proj", blk)
    sap = _qact(acc * s_acc, 16, "s_attn_proj", blk)
    branch = window_reverse(requantize(acc, s_acc, sap, 16).reshape(Bw, N, C), ws, res, res)
    if shift:
        branch = torch.roll(branch, (shift, shift), dims=(1, 2))
    branch = branch.reshape(B, L, C)
    sr1 = _qact(branch * sap + x * s_x, 16, "s_res1", blk)
    return requantize(branch, sap, sr1, 16, x, s_x), sr1


def synthetic_swin_artifact(name: str, seed: int = 0, gelu_stable: bool = False, **overrides) -> dict:
    """A ``freeze_swin``-shaped artifact for registered Swin model
    ``name`` (``overrides`` change config fields, e.g. a tiny test size),
    with random weights from ``seed`` and scales calibrated on two seeded
    normal images, with the plain ops on the CPU."""
    cfg = create_config(name, gelu_stable=gelu_stable, **overrides)
    if "depths" not in cfg:
        raise ValueError(f"{name!r} is not a Swin model")
    D, p, img = cfg["embed_dim"], cfg["patch_size"], cfg["img_size"]
    depths, n_stages = cfg["depths"], len(cfg["depths"])
    init = _Init(seed)

    # parameters, in graph order
    pe_params = init.linear(p * p * 3, D)
    patch_norm = init.norm(D)
    stage_params = []
    for i, depth in enumerate(depths):
        dim, heads = D * 2**i, cfg["num_heads"][i]
        hidden = int(dim * cfg["mlp_ratio"])
        ws = stage_geometry(cfg, i, 0)[1]
        blocks = [
            {
                "norm1": init.norm(dim), "table": init.trunc_normal(((2 * ws - 1) ** 2, heads)),
                "qkv": init.linear(dim, 3 * dim), "proj": init.linear(dim, dim),
                "norm2": init.norm(dim), "fc1": init.linear(dim, hidden), "fc2": init.linear(hidden, dim),
            }
            for _ in range(depth)
        ]
        merging = None
        if i < n_stages - 1:
            merging = {"norm": init.norm(4 * dim), "reduction": (init.trunc_normal((4 * dim, 2 * dim)), None)}
        stage_params.append((blocks, merging))
    norm_params = init.norm(D * 2 ** (n_stages - 1))
    head_params = init.linear(D * 2 ** (n_stages - 1), cfg["num_classes"])
    images = init.normal((_CALIB_IMAGES, img, img, 3))

    a: dict = {"config": cfg}
    B, gh = _CALIB_IMAGES, img // p
    s_in = _qact(images, 8, "input_scale", a)
    x = quantize(images, s_in, 8)
    x = x.reshape(B, gh, p, gh, p, 3).permute(0, 1, 3, 2, 4, 5).reshape(B * gh * gh, p * p * 3)
    acc, s_acc = _calib_linear(x, pe_params, s_in, "patch_embed", a)
    s_bn = _qact(acc * s_acc, 8, "s_before_norm", a)
    y, s_y = _calib_norm(requantize(acc, s_acc, s_bn, 8), patch_norm, "patch_norm", a)
    s_e = _qact(y * s_y, 16, "embed_scale", a)
    x = requantize(y, s_y, s_e, 16)
    s_x = _qact(x * s_e, 16, "tokens_scale", a)
    x = requantize(x, s_e, s_x, 16).reshape(B, gh * gh, D)

    stages = []
    for i, (blocks_params, merging) in enumerate(stage_params):
        blocks = []
        for j, bp in enumerate(blocks_params):
            geometry = stage_geometry(cfg, i, j)
            blk: dict = {"res": geometry[0], "ws": geometry[1], "shift": geometry[2], "heads": cfg["num_heads"][i]}
            x, s_x = _window_attention_half(x, s_x, bp, blk, geometry, B)
            x, s_x = _calib_mlp_half(x, s_x, bp, blk, gelu_stable)
            blocks.append(blk)
        stage = {"blocks": blocks}
        if merging is not None:
            res, L, C = geometry[0], x.shape[1], x.shape[2]
            g = x.reshape(B, res, res, C)
            x = torch.cat([g[:, 0::2, 0::2], g[:, 1::2, 0::2], g[:, 0::2, 1::2], g[:, 1::2, 1::2]], -1)
            ds: dict = {"res": res, "dim": C}
            y, s_y = _calib_norm(x.reshape(B, L // 4, 4 * C), merging["norm"], "norm", ds)
            s_dq = _qact(y * s_y, 8, "s_qact1", ds)
            acc, s_acc = _calib_linear(requantize(y, s_y, s_dq, 8).reshape(-1, 4 * C),
                                       merging["reduction"], s_dq, "reduction", ds)
            s_x = _qact(acc * s_acc, 8, "s_out", ds)
            x = requantize(acc, s_acc, s_x, 8).reshape(B, L // 4, 2 * C)
            stage["downsample"] = ds
        stages.append(stage)
    a["stages"] = stages

    y, s_y = _calib_norm(x, norm_params, "norm", a)
    s2 = _qact(y * s_y, 8, "s_qact2", a)
    pooled = token_mean(requantize(y, s_y, s2, 8))
    s3 = _qact(pooled * s2, 8, "s_qact3", a)
    a["head"] = freeze_linear(*head_params, s3)
    validate_swin_artifact(a)
    return a


def swin_nonzero_probability_share(artifact: dict, images: torch.Tensor, device="cuda") -> list[float]:
    """Per block, the share of 8-bit window attention probabilities that
    are nonzero when the plain engine runs ``images`` on ``device`` — a
    degeneracy check (at N = 49 a uniform row still floors to 2/128)."""
    t = swin_artifact_to_torch(artifact, device)
    shares = []

    def visit(blk: dict, x: torch.Tensor) -> None:
        if "attn" not in blk:  # a patch merging
            return
        q, k, _ = window_attention_inputs(x, blk, kernels=())
        a = blk["attn"]
        sm = window_attention_probabilities(q, k, a["bias"], a["mask"], a["r1"], a["rb"], a["scale"], blk["heads"])
        shares.append(float((sm > 0).to(torch.float32).mean()))

    with torch.inference_mode():
        swin_trunk(patch_embed(images.to(device=device, dtype=torch.float32), t), t, (), on_layer=visit)
    return shares
