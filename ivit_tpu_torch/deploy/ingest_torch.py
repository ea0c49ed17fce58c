"""Ingest the reference's own trained QAT checkpoints into an artifact.

Counterpart of ``ivit_tpu/deploy/ingest_torch.py``, numpy for numpy and
message for message: the reference deploys by reading
``checkpoint.pth.tar``'s named integer buffers — ``weight_integer`` /
``bias_integer`` / ``*_scaling_factor`` — and re-assembling the scale
graph op by op (its ``TVM_benchmark/convert_model.py:12-148``,
``save_params`` and ``load_qconfig``). This module maps those buffers onto
``freeze_vit``'s and ``freeze_swin``'s artifacts, so a model the
reference trained serves on this package's engines with no model code in
the loop: only ``torch.load`` for deserialization
(``ivit_tpu_torch.convert_model --torch-checkpoint``).

The integer weights and every activation scale are taken verbatim from
the reference's buffers; the engine threads the scales through the graph
wiring itself, so handing it the per-QuantAct ``act_scaling_factor``
buffers reproduces the reference's scale chain. Swin's window geometry
comes from ``models.swin`` (``relative_position_index``,
``sw_attn_mask``).
"""

from __future__ import annotations

import re

import numpy as np

from ..models.swin import relative_position_index, sw_attn_mask

_I16 = 2**15 - 1


def _np(sd, key):
    if key not in sd:
        raise KeyError(
            f"reference checkpoint is missing buffer {key!r} — was the "
            "model trained with the I-ViT QAT code (quant_modules.py "
            "registers it) and saved AFTER at least one forward pass?"
        )
    return np.asarray(sd[key])


def _scalar(sd, key):
    v = _np(sd, key).reshape(-1)
    s = np.float32(v[0])
    if s <= 0:
        raise ValueError(
            f"{key} = {float(s)} — the checkpoint's quant state was "
            "never populated (scale buffers are zeros until the first "
            "forward; run calibration/QAT before saving)"
        )
    return s


def _linear(sd, prefix, in_scale):
    """QuantLinear buffers → engine layer dict, weights verbatim.

    Reference layout: ``weight_integer`` (out, in) float-holding-ints,
    ``bias_integer`` at ``fc_scaling_factor · in_scale``
    (quant_modules.py:82-96). Engine layout: ``w`` (in, out) int8,
    ``b`` int32, ``out_scale`` per-out-channel f32.
    """
    w = _np(sd, f"{prefix}.weight_integer")
    out = {
        "w": np.rint(w).astype(np.int8).T.copy(),
        "out_scale": (
            _np(sd, f"{prefix}.fc_scaling_factor").astype(np.float32)
            * in_scale
        ).astype(np.float32),
    }
    bkey = f"{prefix}.bias_integer"
    if bkey in sd:
        out["b"] = np.rint(_np(sd, bkey)).astype(np.int32)
    return out


def _norm(sd, prefix):
    """IntLayerNorm buffers map 1:1: the reference's
    ``norm_scaling_factor`` IS γ·√D/2³⁰ and ``bias_integer`` IS
    ⌊(β/γ)/base⌋ (quant_modules.py:344-385) — the exact pair
    ``_freeze_layernorm`` derives for our own checkpoints."""
    return {
        "bias_int": _np(sd, f"{prefix}.bias_integer").astype(np.float32),
        "out_scale": _np(sd, f"{prefix}.norm_scaling_factor").astype(
            np.float32
        ),
    }


def unwrap_state_dict(obj):
    """checkpoint.pth.tar stores the state dict under ``'model'``
    (quant_train.py resume path reads checkpoint['model']); the TVM
    converter also accepts a bare state dict. Handle both, and map any
    torch tensors to numpy."""
    if hasattr(obj, "keys") and "model" in obj and not any(
        "." in k for k in obj.keys()
    ):
        obj = obj["model"]
    out = {}
    for k, v in obj.items():
        out[k] = v.detach().cpu().numpy() if hasattr(v, "detach") else (
            np.asarray(v)
        )
    return out


def torch_swin_state_to_artifact(
    sd,
    num_heads,
    img_size=224,
    gelu_stable=False,
) -> dict:
    """Reference Swin QAT state dict → deployable integer artifact.

    NEW capability beyond the reference: its own converter handles the
    ViT ``blocks.%d`` names only (TVM_benchmark/convert_model.py:23-45)
    — a Swin model it trains (swin_quant.py) can never be deployed on
    its TVM engine. This maps the Swin QAT buffers (same
    ``weight_integer``/``bias_integer``/``*_scaling_factor`` registry,
    quant_modules.py:50-53,344-345 + the window-attention QuantActs of
    swin_quant.py:102-110) onto our ``freeze_swin`` artifact schema, so
    a reference-trained Swin checkpoint serves on the int8 Swin engine.

    ``num_heads``: per-stage head counts (not recoverable from buffer
    shapes — same contract as the ViT ingester / the reference's own
    ``--depth`` operator input). ``img_size``: the training resolution
    (Swin has no pos-embed to recover it from; validated against the
    checkpoint's own ``attn_mask`` buffers when present).
    """
    pw = _np(sd, "patch_embed.proj.weight_integer")  # (D, C, ph, pw)
    D, p = pw.shape[0], pw.shape[-1]
    depths = []
    while f"layers.{len(depths)}.blocks.0.qact1.act_scaling_factor" in sd:
        d = 1 + max(
            int(m.group(2))
            for k in sd
            if (m := re.match(r"layers\.(\d+)\.blocks\.(\d+)\.", k))
            and int(m.group(1)) == len(depths)
        )
        depths.append(d)
    if not depths:
        raise KeyError(
            "no layers.*.blocks.* buffers — not a Swin QAT state dict"
        )
    num_heads = tuple(int(h) for h in num_heads)
    if len(num_heads) != len(depths):
        raise ValueError(
            f"num_heads {num_heads} does not match the checkpoint's "
            f"{len(depths)} stages"
        )
    # window size from the rel-pos table: (2ws−1)² rows (swin_quant.py:75)
    rows = _np(
        sd, "layers.0.blocks.0.attn.relative_position_bias_table"
    ).shape[0]
    window = (int(round(rows**0.5)) + 1) // 2
    hidden = _np(sd, "layers.0.blocks.0.mlp.fc1.weight_integer").shape[0]
    head_w = _np(sd, "head.weight_integer")
    grid = img_size // p

    a = {
        "config": dict(
            img_size=int(img_size),
            patch_size=int(p),
            embed_dim=int(D),
            depths=tuple(depths),
            num_heads=num_heads,
            window_size=int(window),
            mlp_ratio=hidden / D,
            num_classes=int(head_w.shape[0]),
            gelu_stable=bool(gelu_stable),
        )
    }

    s_input = _scalar(sd, "qact_input.act_scaling_factor")
    a["input_scale"] = s_input
    a["patch_embed"] = {
        "w": np.rint(pw).astype(np.int8).transpose(2, 3, 1, 0)
        .reshape(-1, D).copy(),
        "b": np.rint(_np(sd, "patch_embed.proj.bias_integer")).astype(
            np.int32
        ),
        "out_scale": (
            _np(sd, "patch_embed.proj.conv_scaling_factor").astype(
                np.float32
            )
            * s_input
        ).astype(np.float32),
    }
    a["s_before_norm"] = _scalar(
        sd, "patch_embed.qact_before_norm.act_scaling_factor"
    )
    a["patch_norm"] = _norm(sd, "patch_embed.norm")
    a["embed_scale"] = _scalar(sd, "patch_embed.qact.act_scaling_factor")
    a["tokens_scale"] = _scalar(sd, "qact1.act_scaling_factor")

    stages = []
    for i, depth in enumerate(depths):
        dim = D * 2**i
        res = grid // 2**i
        blocks = []
        for j in range(depth):
            b = f"layers.{i}.blocks.{j}"
            # the reference block's own geometry rules
            # (swin_quant.py:203-205 via freeze_swin): clamp the window
            # to the stage resolution, no shift on even blocks or when
            # one window covers the grid
            ws = min(window, res)
            shift = 0 if j % 2 == 0 else window // 2
            if res <= window:
                shift = 0
            N = ws * ws
            nH = num_heads[i]

            s_qact1 = _scalar(sd, f"{b}.qact1.act_scaling_factor")
            s_attn_out = _scalar(sd, f"{b}.attn.qact3.act_scaling_factor")
            s_qact3 = _scalar(sd, f"{b}.qact3.act_scaling_factor")
            s_gelu_out = _scalar(sd, f"{b}.mlp.qact1.act_scaling_factor")
            s_table = _scalar(sd, f"{b}.attn.qact_table.act_scaling_factor")
            s_bias = _scalar(sd, f"{b}.attn.qact2.act_scaling_factor")

            # rel-pos bias: quantize the float table at s_table (what
            # qact_table does each forward, swin_quant.py:142-147),
            # gather by the checkpoint's own index buffer when present,
            # pre-requantize into the post-merge scale (freeze_swin's
            # bias_req construction)
            table = _np(
                sd, f"{b}.attn.relative_position_bias_table"
            ).astype(np.float32)
            tq = np.clip(np.round(table / s_table), -128, 127)
            ikey = f"{b}.attn.relative_position_index"
            idx = (
                np.asarray(sd[ikey]).astype(np.int64)
                if ikey in sd
                else relative_position_index(ws)
            ).reshape(-1)
            bias_q = tq[idx].reshape(N, N, nH).transpose(2, 0, 1)
            bias_req = np.round(
                bias_q * np.float32(s_table / s_bias)
            ).astype(np.float32)

            mask = sw_attn_mask(res, res, ws, shift)
            mkey = f"{b}.attn_mask"
            if mkey in sd:  # cross-check our mask vs the checkpoint's
                ref_mask = np.asarray(sd[mkey], np.float32)
                if mask is None or mask.shape != ref_mask.shape or not (
                    np.array_equal(mask, ref_mask)
                ):
                    raise ValueError(
                        f"{mkey} disagrees with the geometry-derived "
                        f"SW-MSA mask — wrong --input-size for this "
                        f"checkpoint? (img_size={img_size})"
                    )
            elif shift > 0:
                raise ValueError(
                    f"shifted block {b} has no attn_mask buffer — "
                    f"img_size {img_size} implies shift {shift} at "
                    f"stage {i} but the checkpoint was trained "
                    f"unshifted (different resolution)"
                )
            mask_int = (
                (mask / np.float32(s_bias)).astype(np.float32)
                if mask is not None
                else None
            )

            blocks.append(
                {
                    "res": res, "ws": ws, "shift": shift, "heads": nH,
                    "norm1": _norm(sd, f"{b}.norm1"),
                    "s_qact1": s_qact1,
                    "qkv": _linear(sd, f"{b}.attn.qkv", s_qact1),
                    "s_attn_qact1": _scalar(
                        sd, f"{b}.attn.qact1.act_scaling_factor"
                    ),
                    "s_attn1": _scalar(
                        sd, f"{b}.attn.qact_attn1.act_scaling_factor"
                    ),
                    "bias_req": bias_req,
                    "s_bias": s_bias,
                    "mask_int": mask_int,
                    "s_attn_out": s_attn_out,
                    "proj": _linear(sd, f"{b}.attn.proj", s_attn_out),
                    "s_attn_proj": _scalar(
                        sd, f"{b}.attn.qact4.act_scaling_factor"
                    ),
                    "s_res1": _scalar(sd, f"{b}.qact2.act_scaling_factor"),
                    "norm2": _norm(sd, f"{b}.norm2"),
                    "s_qact3": s_qact3,
                    "fc1": _linear(sd, f"{b}.mlp.fc1", s_qact3),
                    "s_gelu_in": _scalar(
                        sd, f"{b}.mlp.qact_gelu.act_scaling_factor"
                    ),
                    "s_gelu_out": s_gelu_out,
                    "fc2": _linear(sd, f"{b}.mlp.fc2", s_gelu_out),
                    "s_mlp_out": _scalar(
                        sd, f"{b}.mlp.qact2.act_scaling_factor"
                    ),
                    "s_res2": _scalar(sd, f"{b}.qact4.act_scaling_factor"),
                }
            )
        stage = {"blocks": blocks}
        dkey = f"layers.{i}.downsample"
        if f"{dkey}.qact1.act_scaling_factor" in sd:
            s_dq1 = _scalar(sd, f"{dkey}.qact1.act_scaling_factor")
            stage["downsample"] = {
                "res": res, "dim": dim,
                "norm": _norm(sd, f"{dkey}.norm"),
                "s_qact1": s_dq1,
                "reduction": _linear(sd, f"{dkey}.reduction", s_dq1),
                "s_out": _scalar(sd, f"{dkey}.qact2.act_scaling_factor"),
            }
        elif i < len(depths) - 1:
            raise KeyError(
                f"stage {i} is not last but has no downsample buffers"
            )
        stages.append(stage)
    a["stages"] = stages

    a["norm"] = _norm(sd, "norm")
    a["s_qact2"] = _scalar(sd, "qact2.act_scaling_factor")
    a["s_qact3"] = _scalar(sd, "qact3.act_scaling_factor")
    a["head"] = _linear(sd, "head", a["s_qact3"])
    return a


def torch_vit_state_to_artifact(
    sd,
    num_heads,
    softmax_bits=16,
    gelu_stable=False,
) -> dict:
    """Reference ViT/DeiT QAT state dict → deployable integer artifact.

    ``sd``: name → array (use :func:`unwrap_state_dict` on a
    ``torch.load`` result). ``num_heads`` is the one config value not
    recoverable from the buffers (the reference converter likewise
    takes ``--depth`` from the operator, convert_model.py:160).
    ``softmax_bits``/``gelu_stable`` describe the nonlinearity spec the
    checkpoint was trained under (reference ViT QAT: 16-bit softmax,
    standard ShiftGELU — the defaults).
    """
    depth = 1 + max(
        int(m.group(1))
        for k in sd
        if (m := re.match(r"blocks\.(\d+)\.", k))
    )

    cls = _np(sd, "cls_token").astype(np.float32)  # (1, 1, D)
    D = cls.shape[-1]
    pw = _np(sd, "patch_embed.proj.weight_integer")  # (D, C, ph, pw)
    p = pw.shape[-1]
    n_tok = _np(sd, "pos_embed").shape[1]
    gh = int(round((n_tok - 1) ** 0.5))
    head_w = _np(sd, "head.weight_integer")

    a = {
        "config": dict(
            img_size=gh * p,
            patch_size=p,
            embed_dim=D,
            depth=depth,
            num_heads=int(num_heads),
            mlp_ratio=_np(sd, "blocks.0.mlp.fc1.weight_integer").shape[0]
            / D,
            num_classes=head_w.shape[0],
            softmax_bits=int(softmax_bits),
            gelu_stable=bool(gelu_stable),
        )
    }

    s_input = _scalar(sd, "qact_input.act_scaling_factor")
    a["input_scale"] = s_input
    a["patch_embed"] = {
        # conv (D, C, ph, pw) → space-to-depth matmul kernel
        # (ph·pw·C, D), row order (ph, pw, c) — the same layout the
        # float importer uses (models/import_torch.py:101-104)
        "w": np.rint(pw).astype(np.int8).transpose(2, 3, 1, 0)
        .reshape(-1, D).copy(),
        "b": np.rint(_np(sd, "patch_embed.proj.bias_integer")).astype(
            np.int32
        ),
        "out_scale": (
            _np(sd, "patch_embed.proj.conv_scaling_factor").astype(
                np.float32
            )
            * s_input
        ).astype(np.float32),
    }
    s_embed = _scalar(sd, "patch_embed.qact.act_scaling_factor")
    a["embed_scale"] = s_embed

    # cls at the shared embed scale, pos at its own 16-bit scale —
    # the reference's TVM graph quantizes both from the float params
    # it saved (save_params 'cls_token_weight'/'pos_embed_weight',
    # convert_model.py:63-65; graph wiring vit_quant.py:259-265).
    a["cls_q"] = np.round(cls / s_embed).astype(np.float32)
    s_pos = _scalar(sd, "qact_pos.act_scaling_factor")
    a["pos_q"] = np.clip(
        np.round(_np(sd, "pos_embed").astype(np.float32) / s_pos),
        -_I16 - 1,
        _I16,
    ).astype(np.float32)
    a["pos_scale"] = s_pos
    a["tokens_scale"] = _scalar(sd, "qact1.act_scaling_factor")

    blocks = []
    for i in range(depth):
        b = f"blocks.{i}"
        s_qact1 = _scalar(sd, f"{b}.qact1.act_scaling_factor")
        s_attn_out = _scalar(sd, f"{b}.attn.qact2.act_scaling_factor")
        s_qact3 = _scalar(sd, f"{b}.qact3.act_scaling_factor")
        s_gelu_out = _scalar(sd, f"{b}.mlp.qact1.act_scaling_factor")
        blocks.append(
            {
                "norm1": _norm(sd, f"{b}.norm1"),
                "s_qact1": s_qact1,
                "qkv": _linear(sd, f"{b}.attn.qkv", s_qact1),
                "s_attn_qact1": _scalar(
                    sd, f"{b}.attn.qact1.act_scaling_factor"
                ),
                "s_attn_sm_in": _scalar(
                    sd, f"{b}.attn.qact_attn1.act_scaling_factor"
                ),
                "s_attn_out": s_attn_out,
                "proj": _linear(sd, f"{b}.attn.proj", s_attn_out),
                "s_attn_proj": _scalar(
                    sd, f"{b}.attn.qact3.act_scaling_factor"
                ),
                "s_res1": _scalar(sd, f"{b}.qact2.act_scaling_factor"),
                "norm2": _norm(sd, f"{b}.norm2"),
                "s_qact3": s_qact3,
                "fc1": _linear(sd, f"{b}.mlp.fc1", s_qact3),
                "s_gelu_in": _scalar(
                    sd, f"{b}.mlp.qact_gelu.act_scaling_factor"
                ),
                "s_gelu_out": s_gelu_out,
                "fc2": _linear(sd, f"{b}.mlp.fc2", s_gelu_out),
                "s_mlp_out": _scalar(
                    sd, f"{b}.mlp.qact2.act_scaling_factor"
                ),
                "s_res2": _scalar(sd, f"{b}.qact4.act_scaling_factor"),
            }
        )
    a["blocks"] = blocks

    a["norm"] = _norm(sd, "norm")
    a["head_in_scale"] = _scalar(sd, "qact2.act_scaling_factor")
    a["head"] = _linear(sd, "head", a["head_in_scale"])
    return a
