"""Integer-only Swin inference engine (PyTorch).

Counterpart of ``ivit_tpu/deploy/swin_engine.py:build_swin_infer`` in its
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
which is what ``jnp.mean`` computes on the JAX side (``token_mean``).

Entry points run on the card unless the caller passes ``device="cpu"``,
where each kernel's wrapper runs its plain version.
"""

from __future__ import annotations

import torch

from ..kernels import fused_int8_window_attention, fused_int8_window_attention_reference
from ..kernels.attention_fused import MAX_TOKENS
from ..models.swin import stage_geometry, window_partition, window_reverse
from ..ops import INT8, INT16, int_layernorm, requant
from ..ops.interp import div, f32
from .engine import _layernorm, _residual, int8_linear, mlp_half, qkv_heads
from .swin_artifact import swin_artifact_to_torch

KERNEL_NAMES = ("attention", "layernorm")
DEFAULT_KERNELS = KERNEL_NAMES


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


def swin_block(x: torch.Tensor, blk: dict, cfg: dict, kernels=DEFAULT_KERNELS) -> torch.Tensor:
    """One shifted-window block on the int16 stream (B, L, C)."""
    B, L, C = x.shape
    res, ws, shift, H = blk["res"], blk["ws"], blk["shift"], blk["heads"]
    q, k, v = window_attention_inputs(x, blk, kernels)
    a = blk["attn"]
    attend = fused_int8_window_attention if "attention" in kernels else fused_int8_window_attention_reference
    ctx = attend(q, k, v, a["bias"], a["mask"], a["r1"], a["rb"], a["scale"], a["r_out"], H)
    # head merge: contracting (H, hd) with the proj weight is this GEMM
    G, N, hd = ctx.shape
    ctx = ctx.view(G // H, H, N, hd).permute(0, 2, 1, 3).reshape(-1, C)
    proj = blk["proj"]
    branch = requant(int8_linear(ctx, proj), proj["ratio"], *INT16).to(torch.int16)
    g = window_reverse(branch.view(-1, N, C), ws, res, res)
    if shift:
        g = torch.roll(g, (shift, shift), dims=(1, 2))
    h = _residual(g.reshape(B * L, C).to(torch.float32), x.reshape(B * L, C), blk["res1"])
    return mlp_half(h, blk, cfg, kernels).view(B, L, C)


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


def token_mean(y: torch.Tensor, inv_tokens: torch.Tensor | None = None) -> torch.Tensor:
    """The mean over tokens of integer (B, L, C) ``y`` as JAX's
    ``jnp.mean`` computes it: the exact sum times float32(1/L). Neither a
    correctly rounded quotient (``torch.mean`` on the CPU) nor ATen's CUDA
    mean is that value. ``inv_tokens`` is that 1/L as a tensor on y's
    device (the engine carries it); without it, it is divided here."""
    L = y.shape[1]
    total = y.to(torch.int32).sum(1, dtype=torch.int32).to(torch.float32)
    if inv_tokens is None:
        inv_tokens = div(f32(1.0, y.device), float(L))
    return total * inv_tokens


def swin_trunk(x: torch.Tensor, t: dict, kernels=DEFAULT_KERNELS, on_layer=None) -> torch.Tensor:
    """Run every stage's blocks and patch merging on the token stream;
    ``on_layer(layer, x)`` sees the input stream of each block and each
    patch merging (``layer`` is its carried dict) before it runs."""
    for stage in t["stages"]:
        layers = stage["blocks"] + ([stage["downsample"]] if "downsample" in stage else [])
        for layer in layers:
            if on_layer is not None:
                on_layer(layer, x)
            if "attn" in layer:
                x = swin_block(x, layer, t["config"], kernels)
            else:
                x = patch_merging(x, layer, kernels)
    return x


def build_swin_infer(artifact: dict, device="cuda", kernels=DEFAULT_KERNELS):
    """Build the int8 Swin inference function: NHWC float images → logits.

    ``artifact`` is a ``freeze_swin`` dict (numpy arrays). ``kernels``
    names the chains that run through hand-written kernels (module
    docstring); ``kernels=()`` is the plain path. The engine runs on the
    card unless ``device`` says otherwise, and raises if there is none;
    on the CPU every kernel's wrapper runs its plain version. The kernels
    in use are ``infer.kernels``.
    """
    t = swin_artifact_to_torch(artifact, device)
    active = select_swin_kernels(t["config"], kernels)

    @torch.inference_mode()
    def infer(images: torch.Tensor) -> torch.Tensor:
        x = swin_trunk(patch_embed(images.to(device=device, dtype=torch.float32), t), t, active)
        B, L, C = x.shape
        y = _layernorm(x.reshape(B * L, C), t["norm"], active).view(B, L, C)
        y8 = requant(token_mean(y, t["inv_tokens"]), t["pool_ratio"], *INT8).to(torch.int8)
        head = t["head"]
        return int8_linear(y8, head).to(torch.float32) * head["out_scale"]

    infer.tensors = t
    infer.kernels = active
    return infer
