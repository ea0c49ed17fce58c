"""Integer-only Swin deployment: freezing and the inference engine
(PyTorch).

``freeze_swin`` is the counterpart of ``ivit_tpu/deploy/swin_engine.py:
freeze_swin``: a trained QAT ``SwinTransformer`` into the artifact the
engine serves, each block's relative-position bias pre-gathered and
pre-requantized into the merged score scale (``window_bias``) and its
shifted-window mask divided by that scale (``window_mask``).

``build_swin_infer`` is the counterpart of ``build_swin_infer`` in its
default layout (the TPU layout probes ``win_pad``, ``qkv_hmajor``,
``qkv_wmajor``, ``scores_f32`` and the int-lane twins give the same
integers and are not ported). JAX's kernel selection (``use_pallas`` with
``pallas_ops``) is ``kernels=``:

* ``"attention"``: every window attention (int8 Q·Kᵀ → requant → bias
  merge → mask → 8-bit Shiftmax → @V → requant) runs through K7
  (``kernels.fused_int8_window_attention``), once per block;
* ``"layernorm"``: every I-LayerNorm → int8 requant runs through K3
  (``kernels.fused_layernorm_requant``): two per block, one per patch
  merging and the final norm (28 a Swin-T forward). The patch norm
  requantizes to int16 and stays plain.

The default is both; ``kernels=()`` is the plain path, the oracle, like
the JAX engine's ``use_pallas=False``. Any other name raises
``ValueError``, and so does ``"attention"`` on a window of more than 256
tokens (the exact row-sum bound): where JAX falls back to its XLA path
per block, the port raises at build time, so that a launch count proves
the kernel ran. The Swin path has no GELU or softmax kernel (neither has
JAX's).

The GEMMs are ``torch._int_mm`` with plain epilogues, as in
``deploy/engine.py``, whose ``int8_linear``, ``qkv_heads``, ``mlp_half``,
``_layernorm`` and ``_residual`` the blocks reuse. The residual stream is
int16; a patch merging's int8 output rides in it. The token-mean pool is
an exact integer sum times the float32 reciprocal of the token count,
which is what the jitted ``jnp.mean`` computes on the JAX side
(``models.swin.token_mean``).

Entry points run on the card unless the caller passes ``device="cpu"``,
where each kernel's wrapper runs its plain version.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import quantize
from ..kernels import fused_int8_window_attention, fused_int8_window_attention_reference
from ..kernels.attention_fused import MAX_TOKENS
from ..models.swin import (
    gather_bias,
    stage_geometry,
    sw_attn_mask,
    token_mean,
    window_partition,
    window_reverse,
)
from ..ops import INT8, INT16, int_layernorm, requant
from ..ops.interp import div
from ..utils.spans import Span
from .convert import TrainedVariables, _np, scalar
from .engine import ATTENTION, EMBED, HEAD, MLP, _layernorm, _residual, int8_linear, mlp_half, qkv_heads
from .swin_artifact import swin_artifact_to_torch, validate_swin_artifact

KERNEL_NAMES = ("attention", "layernorm")
DEFAULT_KERNELS = KERNEL_NAMES
MERGE = Span("engine.merge")  # a patch merging; the other stages are deploy/engine.py's


def window_bias(table: torch.Tensor, s_table: torch.Tensor, s_bias: torch.Tensor, ws: int) -> torch.Tensor:
    """A block's relative-position bias as it is frozen, ``bias_req``: the
    (T, H) table quantized at ``s_table``, ``tq = clip(round(table /
    s_table))``, gathered to (H, N, N), and requantized into the merged
    score scale, ``round(tq · f32(s_table/s_bias))``; integer-valued
    float32 on the table's device (the scales there too)."""
    bias_q = gather_bias(quantize(table, s_table, 8), ws)
    return torch.round(bias_q * div(s_table, s_bias))


def window_mask(res: int, ws: int, shift: int, s_bias: torch.Tensor) -> torch.Tensor | None:
    """A block's shifted-window mask at the merged score scale,
    ``mask_int = f32(mask/s_bias)``, (nW, N, N) on ``s_bias``'s device;
    None for an unshifted block."""
    mask = sw_attn_mask(res, res, ws, shift)
    return None if mask is None else div(torch.from_numpy(mask).to(s_bias.device), s_bias)


def freeze_swin(model: torch.nn.Module, variables: dict | None = None, device="cuda") -> dict:
    """The artifact of the QAT ``SwinTransformer`` ``model`` on
    ``variables`` (``{"params", "quant_stats"}`` keyed by torch name, as
    ``models.model_utils.eval_variables`` gives them; the model's own
    when None), computed on ``device`` (raises for a CUDA device on a
    machine without one). It has ``freeze_swin``'s keys, dtypes, shapes
    and geometry (``deploy.swin_artifact.validate_swin_artifact``).

    Raises ``NotImplementedError`` for a model with an absolute position
    embedding (``ape``): JAX's ``freeze_swin`` never reads it, so its
    artifact would compute another function than the model."""
    if model.ape:
        raise NotImplementedError("freeze_swin: the artifact has no absolute position embedding (ape=True); "
                                  "JAX's freeze_swin drops it, so the frozen model would differ")
    v = TrainedVariables(model, variables, device)
    act, linear, norm = v.act, v.linear, v.norm
    cfg = dict(model.config)

    a: dict = {"config": cfg}
    s_input = act("qact_input", 8)
    a["input_scale"] = scalar(s_input)
    a["patch_embed"] = linear("patch_embed.proj", s_input)
    a["s_before_norm"] = scalar(act("qact_before_norm", 8))
    a["patch_norm"] = norm("patch_norm")
    a["embed_scale"] = scalar(act("qact_embed", 16))
    a["tokens_scale"] = scalar(act("qact1", 16))

    stages = []
    for i, depth in enumerate(cfg["depths"]):
        blocks = []
        for j in range(depth):
            b = f"layers_{i}_blocks_{j}"
            res, ws, shift = stage_geometry(cfg, i, j)
            s_qact1, s_bias = act(f"{b}.qact1", 8), act(f"{b}.attn.qact2", 8)
            s_attn_out, s_qact3 = act(f"{b}.attn.qact3", 8), act(f"{b}.qact3", 8)
            s_gelu_out = act(f"{b}.mlp.qact1", 8)
            bias_req = window_bias(v.params[f"{b}.attn.relative_position_bias_table"],
                                      act(f"{b}.attn.qact_table", 8), s_bias, ws)
            mask_int = window_mask(res, ws, shift, s_bias)
            blocks.append({
                "res": res, "ws": ws, "shift": shift, "heads": cfg["num_heads"][i],
                "norm1": norm(f"{b}.norm1"),
                "s_qact1": scalar(s_qact1),
                "qkv": linear(f"{b}.attn.qkv", s_qact1),
                "s_attn_qact1": scalar(act(f"{b}.attn.qact1", 8)),
                "s_attn1": scalar(act(f"{b}.attn.qact_attn1", 8)),
                "bias_req": _np(bias_req, np.float32),
                "s_bias": scalar(s_bias),
                "mask_int": None if mask_int is None else _np(mask_int, np.float32),
                "s_attn_out": scalar(s_attn_out),
                "proj": linear(f"{b}.attn.proj", s_attn_out),
                "s_attn_proj": scalar(act(f"{b}.attn.qact4", 16)),
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
        stage = {"blocks": blocks}
        if i < len(cfg["depths"]) - 1:
            d = f"layers_{i}_downsample"
            s_dq1 = act(f"{d}.qact1", 8)
            stage["downsample"] = {
                "res": stage_geometry(cfg, i, 0)[0], "dim": cfg["embed_dim"] * 2**i,
                "norm": norm(f"{d}.norm"),
                "s_qact1": scalar(s_dq1),
                "reduction": linear(f"{d}.reduction", s_dq1),
                "s_out": scalar(act(f"{d}.qact2", 8)),
            }
        stages.append(stage)
    a["stages"] = stages

    a["norm"] = norm("norm")
    a["s_qact2"] = scalar(act("qact2", 8))
    s_qact3 = act("qact3", 8)
    a["s_qact3"] = scalar(s_qact3)
    a["head"] = linear("head", s_qact3)
    validate_swin_artifact(a)
    return a


def select_swin_kernels(cfg: dict, kernels=DEFAULT_KERNELS) -> frozenset:
    """The kernels a Swin model of config ``cfg`` runs when ``kernels``
    are asked for; raises ``ValueError`` for an unknown name and for
    ``"attention"`` on a window over 256 tokens (module docstring)."""
    unknown = set(kernels) - set(KERNEL_NAMES)
    if unknown:
        raise ValueError(f"unknown kernels {sorted(unknown)}; the Swin engine knows {KERNEL_NAMES}")
    if "attention" in kernels:
        n = max(stage_geometry(cfg, i, 0)[1] ** 2 for i in range(len(cfg["depths"])))
        if n > MAX_TOKENS:
            raise ValueError(
                f"attention: a window of N={n} tokens exceeds the fused window attention "
                f"bound of {MAX_TOKENS} (window_size {cfg['window_size']} > 16)"
            )
    return frozenset(kernels)


def patch_embed(images: torch.Tensor, t: dict) -> torch.Tensor:
    """NHWC float32 images → the int16 token stream (B, L, D): input
    quantization, space-to-depth patch embed, requant to int8, the patch
    norm (I-LayerNorm with its integer β, requantized to int16), and the
    token-scale requant."""
    cfg = t["config"]
    p, D = cfg["patch_size"], cfg["embed_dim"]
    gh = cfg["img_size"] // p
    B = images.shape[0]
    x = torch.clamp(torch.round(div(images, t["input_scale"])), *INT8).to(torch.int8)
    x = x.reshape(B, gh, p, gh, p, 3).permute(0, 1, 3, 2, 4, 5).reshape(B * gh * gh, p * p * 3)
    pe, pn = t["patch_embed"], t["patch_norm"]
    x = requant(int8_linear(x, pe), pe["ratio"], *INT8)
    ones = torch.ones(D, dtype=torch.float32, device=x.device)
    y, _ = int_layernorm(x, ones, torch.zeros_like(ones))
    x = requant(y + pn["bias_int"], pn["ratio"], *INT16)
    x = torch.clamp(torch.round(x * t["embed_to_tokens"]), *INT16)
    return x.to(torch.int16).reshape(B, gh * gh, D)


def window_attention_inputs(x: torch.Tensor, blk: dict, kernels=DEFAULT_KERNELS):
    """norm1 → cyclic shift → window partition → qkv GEMM → requant →
    head split of the int16 stream (B, L, C); returns contiguous int8 q,
    k, v of shape (B·nW·H, N, hd), the head innermost."""
    B, L, C = x.shape
    res, ws, shift = blk["res"], blk["ws"], blk["shift"]
    y = _layernorm(x.reshape(B * L, C), blk["norm1"], kernels).view(B, res, res, C)
    if shift:
        y = torch.roll(y, (-shift, -shift), dims=(1, 2))
    xw = window_partition(y, ws)
    return qkv_heads(xw.reshape(-1, C), blk["qkv"], xw.shape[0], blk["heads"])


def window_attention_half(x: torch.Tensor, blk: dict, kernels=DEFAULT_KERNELS) -> torch.Tensor:
    """The attention half of a shifted-window block on the int16 stream
    (B, L, C): qkv, the window attention, proj, window reverse and the
    reverse shift; returns the (B·L, C) int16 stream after the first
    residual (``deploy/engine.py:attention_half``'s counterpart)."""
    B, L, C = x.shape
    res, ws, shift, H = blk["res"], blk["ws"], blk["shift"], blk["heads"]
    q, k, v = window_attention_inputs(x, blk, kernels)
    a = blk["attn"]
    attend = fused_int8_window_attention if "attention" in kernels else fused_int8_window_attention_reference
    ctx = attend(q, k, v, a["bias"], a["mask"], a["r1"], a["rb"], a["scale"], a["r_out"], H)
    # head merge: contracting (H, hd) with the proj weight is this GEMM
    G, N, hd = ctx.shape
    ctx = ctx.view(G // H, H, N, hd).permute(0, 2, 1, 3).reshape(-1, H * hd)
    proj = blk["proj"]
    branch = requant(int8_linear(ctx, proj), proj["ratio"], *INT16).to(torch.int16)
    g = window_reverse(branch.view(-1, N, C), ws, res, res)
    if shift:
        g = torch.roll(g, (shift, shift), dims=(1, 2))
    return _residual(g.reshape(B * L, C).to(torch.float32), x.reshape(B * L, C), blk["res1"])


def swin_block(x: torch.Tensor, blk: dict, cfg: dict, kernels=DEFAULT_KERNELS) -> torch.Tensor:
    """One shifted-window block on the int16 stream (B, L, C)."""
    return mlp_half(window_attention_half(x, blk, kernels), blk, cfg, kernels).view(x.shape)


def patch_merging(x: torch.Tensor, ds: dict, kernels=DEFAULT_KERNELS) -> torch.Tensor:
    """2×2 gather → I-LayerNorm on 4C → bias-free reduction GEMM →
    requant to int8; returns the (B, L/4, 2C) stream as int16."""
    B, L, C = x.shape
    y = _layernorm(merge_gather(x, ds["res"]), ds["norm"], kernels)
    red = ds["reduction"]
    out = requant(int8_linear(y, red), red["ratio"], *INT8)
    return out.to(torch.int16).view(B, L // 4, 2 * C)


def merge_gather(x: torch.Tensor, res: int) -> torch.Tensor:
    """The 2×2 neighbourhood gather of the (B, res², C) stream into
    contiguous (B·res²/4, 4C) rows, in the reference's concat order."""
    B, L, C = x.shape
    g = x.view(B, res, res, C)
    q = torch.cat([g[:, 0::2, 0::2], g[:, 1::2, 0::2], g[:, 0::2, 1::2], g[:, 1::2, 1::2]], -1)
    return q.reshape(B * L // 4, 4 * C)


def swin_trunk(x: torch.Tensor, t: dict, kernels=DEFAULT_KERNELS, on_layer=None) -> torch.Tensor:
    """Run every stage's blocks and patch merging on the token stream, a
    block in the spans ``engine.attention`` and ``engine.mlp``, a patch
    merging in ``engine.merge``; ``on_layer(layer, x)`` sees the input
    stream of each block and each patch merging (``layer`` is its
    carried dict) before it runs."""
    for stage in t["stages"]:
        layers = stage["blocks"] + ([stage["downsample"]] if "downsample" in stage else [])
        for layer in layers:
            if on_layer is not None:
                on_layer(layer, x)
            if "attn" in layer:
                with ATTENTION:
                    h = window_attention_half(x, layer, kernels)
                with MLP:
                    x = mlp_half(h, layer, t["config"], kernels).view(x.shape)
            else:
                with MERGE:
                    x = patch_merging(x, layer, kernels)
    return x


def swin_forward(images: torch.Tensor, t: dict, kernels: frozenset) -> torch.Tensor:
    """The engine's forward on carried tensors ``t``: float32 NHWC images
    on ``t``'s device → logits, in the spans ``engine.embed``, the
    trunk's (``swin_trunk``), then ``engine.head``."""
    with EMBED:
        x = patch_embed(images, t)
    x = swin_trunk(x, t, kernels)
    with HEAD:
        B, L, C = x.shape
        y = _layernorm(x.reshape(B * L, C), t["norm"], kernels).view(B, L, C)
        y8 = requant(token_mean(y, t["inv_tokens"]), t["pool_ratio"], *INT8).to(torch.int8)
        head = t["head"]
        return int8_linear(y8, head).to(torch.float32) * head["out_scale"]


def build_swin_infer(artifact: dict, device="cuda", kernels=DEFAULT_KERNELS):
    """Build the int8 Swin inference function: NHWC float images → logits.

    ``artifact`` is a ``freeze_swin`` dict (numpy arrays). ``kernels``
    names the chains that run through hand-written kernels (module
    docstring); ``kernels=()`` is the plain path. The engine runs on the
    card unless ``device`` says otherwise, and raises if there is none;
    on the CPU every kernel's wrapper runs its plain version. The kernels
    in use are ``infer.kernels``, its device ``infer.device``.
    """
    t = swin_artifact_to_torch(artifact, device)
    active = select_swin_kernels(t["config"], kernels)

    @torch.inference_mode()
    def infer(images: torch.Tensor) -> torch.Tensor:
        return swin_forward(images.to(device=device, dtype=torch.float32), t, active)

    infer.tensors = t
    infer.kernels = active
    infer.device = torch.device(device)
    return infer
