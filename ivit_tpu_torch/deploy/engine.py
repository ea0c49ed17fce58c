"""Integer-only ViT inference engine (PyTorch).

Counterpart of ``ivit_tpu/deploy/engine.py:build_vit_infer``, the
pure-XLA path's arithmetic, with two kernels in place of its attention
and LayerNorm chains:

* every I-LayerNorm → requant runs through K3
  (``kernels.fused_layernorm_requant``): 2·depth + 1 launches a forward;
* every attention (int8 Q·Kᵀ → requant → Shiftmax → @V → requant) runs
  through K1 (``kernels.fused_int8_attention``): depth launches a forward,
  at every batch size.

The GEMMs (patch embed, qkv, proj, fc1, fc2, head) lie outside every
Pallas kernel in JAX too (XLA int8 ``dot_general``); here they are
``torch._int_mm`` (int8 → int32) with their requant, ShiftGELU and
residual epilogues as plain tensor ops. The residual stream is int16.
The only float op is the final logit dequantization.

Not ported: ``attn_v_mode="f32"``, ``strict_dyadic``, ``pallas_ops``
selection, and the TPU layout/HBM probes and XLA barriers. Models with
more than 256 tokens raise (the K1 bound); there is no fallback.
"""

from __future__ import annotations

import torch

from ..kernels import (
    fused_int8_attention,
    fused_int8_attention_reference,
    fused_layernorm_requant,
    fused_layernorm_requant_reference,
)
from ..kernels.attention_fused import MAX_TOKENS
from ..ops import INT8, INT16, requant, shiftgelu
from ..ops.interp import div
from .artifact import artifact_to_torch

# torch._int_mm on CUDA takes only more than 16 rows
_INT_MM_MIN_ROWS = 17


def int8_linear(x: torch.Tensor, layer: dict) -> torch.Tensor:
    """(M, K) int8 @ w (K, N) int8 + b → (M, N) int32, exact."""
    M = x.shape[0]
    if x.is_cuda and M < _INT_MM_MIN_ROWS:
        pad = x.new_zeros((_INT_MM_MIN_ROWS - M, x.shape[1]))
        acc = torch._int_mm(torch.cat([x, pad]), layer["w"])[:M]
    else:
        acc = torch._int_mm(x.contiguous(), layer["w"])
    return acc + layer["b"]


def _layernorm(x: torch.Tensor, norm: dict, use_kernels: bool) -> torch.Tensor:
    fn = fused_layernorm_requant if use_kernels else fused_layernorm_requant_reference
    return fn(x, norm["bias_int"], norm["ratio"])


def _residual(branch: torch.Tensor, skip: torch.Tensor, r: dict) -> torch.Tensor:
    """Dual-scale 16-bit residual merge of an integer-valued float32
    branch and the int16 stream."""
    merged = torch.round(branch * r["branch"]) + torch.round(skip.to(torch.float32) * r["skip"])
    return torch.clamp(merged, *INT16).to(torch.int16)


def embed(images: torch.Tensor, t: dict) -> torch.Tensor:
    """NHWC float32 images → the int16 token stream (B, N, D): input
    quantization, space-to-depth patch embed, cls concat, pos-embed merge."""
    cfg = t["config"]
    p, D = cfg["patch_size"], cfg["embed_dim"]
    gh = cfg["img_size"] // p
    B = images.shape[0]
    x = torch.clamp(torch.round(div(images, t["input_scale"])), *INT8).to(torch.int8)
    x = x.reshape(B, gh, p, gh, p, 3).permute(0, 1, 3, 2, 4, 5).reshape(B * gh * gh, p * p * 3)
    pe = t["patch_embed"]
    x = requant(int8_linear(x, pe), pe["ratio"], *INT16).reshape(B, gh * gh, D)
    x = torch.cat([t["cls_q"].expand(B, 1, D), x], dim=1)
    x = torch.clamp(torch.round(x * t["embed_to_tokens"]) + t["pos"], *INT16)
    return x.to(torch.int16)


def attention_inputs(x: torch.Tensor, blk: dict, num_heads: int, use_kernels: bool = True):
    """LayerNorm → qkv GEMM → requant → head split of the int16 stream
    (B, N, C); returns contiguous int8 q, k, v of shape (B·H, N, hd)."""
    B, N, C = x.shape
    hd = C // num_heads
    y = _layernorm(x.reshape(B * N, C), blk["norm1"], use_kernels)
    qkv = blk["qkv"]
    z = requant(int8_linear(y, qkv), qkv["ratio"], *INT8).to(torch.int8)
    z = z.reshape(B, N, 3, num_heads, hd).permute(2, 0, 3, 1, 4).contiguous()
    z = z.view(3, B * num_heads, N, hd)
    return z[0], z[1], z[2]


def vit_block(x: torch.Tensor, blk: dict, cfg: dict, use_kernels: bool = True) -> torch.Tensor:
    """One pre-norm transformer block on the int16 stream (B, N, C)."""
    B, N, C = x.shape
    H = cfg["num_heads"]
    q, k, v = attention_inputs(x, blk, H, use_kernels)
    attn = fused_int8_attention if use_kernels else fused_int8_attention_reference
    a = blk["attn"]
    ctx = attn(q, k, v, a["r1"], a["scale"], a["r_out"], out_bits=int(cfg["softmax_bits"]))
    ctx = ctx.reshape(B, H, N, C // H).permute(0, 2, 1, 3).reshape(B * N, C)

    proj = blk["proj"]
    branch = requant(int8_linear(ctx, proj), proj["ratio"], *INT16)
    x = _residual(branch, x.reshape(B * N, C), blk["res1"])

    y = _layernorm(x, blk["norm2"], use_kernels)
    fc1 = blk["fc1"]
    gq = requant(int8_linear(y, fc1), fc1["ratio"], *INT8)
    g, _ = shiftgelu(gq, blk["gelu"]["scale"], out_bits=8, stable=bool(cfg["gelu_stable"]))
    g8 = requant(g, blk["gelu"]["ratio"], *INT8).to(torch.int8)
    fc2 = blk["fc2"]
    m = requant(int8_linear(g8, fc2), fc2["ratio"], *INT16)
    return _residual(m, x, blk["res2"]).reshape(B, N, C)


def build_vit_infer(artifact: dict, device="cpu", use_kernels: bool = True):
    """Build the int8 inference function: NHWC float images → logits.

    ``artifact`` is a ``freeze_vit`` dict (numpy arrays). On a CUDA
    ``device`` the attention and LayerNorm chains launch K1 and K3;
    ``use_kernels=False`` runs their plain torch versions instead (the
    oracle, like the JAX engine's ``use_pallas=False``). On the CPU both
    run the plain versions.
    """
    t = artifact_to_torch(artifact, device)
    cfg = t["config"]
    n_tokens = (cfg["img_size"] // cfg["patch_size"]) ** 2 + 1
    if n_tokens > MAX_TOKENS:
        raise ValueError(
            f"N={n_tokens} tokens exceeds the fused attention bound of {MAX_TOKENS}"
        )

    @torch.inference_mode()
    def infer(images: torch.Tensor) -> torch.Tensor:
        x = embed(images.to(device=device, dtype=torch.float32), t)
        for blk in t["blocks"]:
            x = vit_block(x, blk, cfg, use_kernels)
        # final norm on the CLS rows only (row-wise: the other rows'
        # values never reach the head)
        y = _layernorm(x[:, 0].contiguous(), t["norm"], use_kernels)
        head = t["head"]
        return int8_linear(y, head).to(torch.float32) * head["out_scale"]

    infer.tensors = t
    return infer
