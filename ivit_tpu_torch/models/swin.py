"""Integer-only Swin Transformer: configurations, window geometry, and
the QAT model.

Counterpart of ``ivit_tpu/models/swin.py``. ``swin_config`` is the
artifact ``config`` dict the Swin engine reads (the keys ``freeze_swin``
records under ``artifact["config"]``), and the factories at the end give
it for each registered width. ``SwinTransformer`` is the QAT model those
configurations build (``models.registry.create_model``), run under the
``SIM`` interpreter: shifted-window blocks whose quantized
relative-position bias merges into the scores in a dual-scale
``QuantAct``, the shifted-window mask added to the scores at their
scale, 2×2 patch merging, and a token-mean pool. Submodules keep flax's
names (``layers_{i}_blocks_{j}``, ``layers_{i}_downsample``,
``attn.relative_position_bias_table``), so ``nn.flax_state`` carries a
flax Swin's variables across.

``remat=True`` recomputes each ``SwinBlock`` in the backward, as JAX's
``nn.remat(SwinBlock)`` does (``PatchMerging`` keeps its activations,
as in JAX), by ``nn.remat`` as ``models/vit.py`` says.
"""

from __future__ import annotations

import functools
from functools import partial

import numpy as np
import torch
from torch import nn

from ..core.qtensor import QTensor
from ..nn.quant import IntLayerNorm, IntSoftmax, QuantAct, QuantLinear, QuantPatchEmbed, exact_int_matmul, trunc_normal_
from ..nn.remat import remat as remat_block
from ..nn.vit_blocks import Mlp, drop_path, head_logits, quant_dropout
from ..ops.interp import div, f32


def swin_config(
    img_size: int = 224,
    patch_size: int = 4,
    num_classes: int = 1000,
    embed_dim: int = 96,
    depths=(2, 2, 6, 2),
    num_heads=(3, 6, 12, 24),
    window_size: int = 7,
    mlp_ratio: float = 4.0,
    gelu_stable: bool = False,
) -> dict:
    """The artifact ``config`` dict of a SwinTransformer."""
    return dict(
        img_size=img_size,
        patch_size=patch_size,
        embed_dim=embed_dim,
        depths=tuple(depths),
        num_heads=tuple(num_heads),
        window_size=window_size,
        mlp_ratio=mlp_ratio,
        num_classes=num_classes,
        gelu_stable=gelu_stable,
    )


swin_tiny_patch4_window7_224 = partial(swin_config, embed_dim=96, depths=(2, 2, 6, 2), num_heads=(3, 6, 12, 24))
swin_small_patch4_window7_224 = partial(swin_config, embed_dim=96, depths=(2, 2, 18, 2), num_heads=(3, 6, 12, 24))
swin_base_patch4_window7_224 = partial(swin_config, embed_dim=128, depths=(2, 2, 18, 2), num_heads=(4, 8, 16, 32))


def stage_geometry(cfg: dict, stage: int, block: int) -> tuple[int, int, int]:
    """``(res, ws, shift)`` of a block: the stage's grid side, the window
    (clamped to the grid) and the cyclic shift (odd blocks, unless one
    window covers the grid), as ``freeze_swin`` sets them."""
    res = cfg["img_size"] // cfg["patch_size"] // 2**stage
    ws = min(cfg["window_size"], res)
    shift = 0 if block % 2 == 0 or res <= cfg["window_size"] else cfg["window_size"] // 2
    return res, ws, shift


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) → (B·nW, ws·ws, C), contiguous."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // ws, ws, W // ws, ws, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, C)


def window_reverse(x: torch.Tensor, ws: int, H: int, W: int) -> torch.Tensor:
    """(B·nW, ws·ws, C) → (B, H, W, C), contiguous."""
    C = x.shape[-1]
    B = x.shape[0] // ((H // ws) * (W // ws))
    x = x.reshape(B, H // ws, W // ws, ws, ws, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, C)


@functools.lru_cache(maxsize=None)
def relative_position_index(ws: int) -> np.ndarray:
    """Static (ws², ws²) index into the (2ws−1)² relative-position bias
    table."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]  # (2, N, N)
    rel = rel.transpose(1, 2, 0) + (ws - 1)
    return (rel[..., 0] * (2 * ws - 1) + rel[..., 1]).astype(np.int32)


@functools.lru_cache(maxsize=None)
def sw_attn_mask(H: int, W: int, ws: int, shift: int) -> np.ndarray | None:
    """Static shifted-window mask (nW, ws², ws²) of {0, −100}; ``None``
    without a shift."""
    if shift == 0:
        return None
    img = np.zeros((1, H, W, 1), np.float32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[:, hs, wsl, :] = cnt
            cnt += 1
    win = img.reshape(1, H // ws, ws, W // ws, ws, 1)
    win = win.transpose(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws)
    diff = win[:, None, :] - win[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _index_on(ws: int, device: torch.device) -> torch.Tensor:
    """``relative_position_index(ws)`` flat, as an int64 tensor on
    ``device``, made once: a copy from the host at every forward would
    wait on the stream."""
    with torch.inference_mode(False):
        return torch.from_numpy(relative_position_index(ws).reshape(-1).astype(np.int64)).to(device)


@functools.lru_cache(maxsize=None)
def _mask_on(H: int, W: int, ws: int, shift: int, device: torch.device) -> torch.Tensor | None:
    """``sw_attn_mask(H, W, ws, shift)`` on ``device``, made once."""
    mask = sw_attn_mask(H, W, ws, shift)
    if mask is None:
        return None
    with torch.inference_mode(False):
        return torch.from_numpy(mask).to(device)


def gather_bias(table_q: torch.Tensor, ws: int) -> torch.Tensor:
    """The (H, N, N) relative-position bias of a window of ``ws²`` tokens
    from the (T, H) table ``table_q``: entry (h, i, j) is row
    ``relative_position_index(ws)[i, j]`` of head h."""
    N, H = ws * ws, table_q.shape[1]
    return table_q[_index_on(ws, table_q.device)].reshape(N, N, H).permute(2, 0, 1)


def token_mean(y: torch.Tensor, inv_tokens: torch.Tensor | None = None) -> torch.Tensor:
    """The mean over tokens of integer-valued (B, L, C) ``y`` as JAX's
    jitted ``jnp.mean`` computes it: the exact sum times float32(1/L).
    ``y`` is the engine's integer stream (summed in int32) or the SIM
    model's float32 carrier, whose sums of integers are exact below 2^24
    and whose gradient passes through. Neither a correctly rounded
    quotient (``torch.mean`` on the CPU, and JAX's mean run under
    ``jax.disable_jit()``) nor ATen's CUDA mean is that value
    (``ROADMAP.md`` §3). ``inv_tokens`` is that 1/L as a tensor on y's
    device (the engine carries it); without it, it is divided here."""
    L = y.shape[1]
    if y.is_floating_point():
        total = y.sum(1)
    else:
        total = y.to(torch.int32).sum(1, dtype=torch.int32).to(torch.float32)
    if inv_tokens is None:
        inv_tokens = div(f32(1.0, y.device), float(L))
    return total * inv_tokens


class WindowAttention(nn.Module):
    """Window attention with the quantized relative-position bias: qkv →
    qact → exact q·kᵀ at ``s·s·D^-0.5`` → qact → the bias table quantized
    on its own (``qact_table``), gathered to (H, N, N) and merged by the
    dual-scale ``qact2`` → the shifted-window mask divided by the merged
    scale and added to the scores → 8-bit Shiftmax → exact attn·v → qact
    → proj → qact (16 bits)."""

    def __init__(self, dim: int, window_size: int, num_heads: int, qkv_bias: bool = True,
                 attn_drop: float = 0.0, proj_drop: float = 0.0):
        super().__init__()
        self.window_size, self.num_heads = window_size, num_heads
        self.head_dim = dim // num_heads
        self.heads = (0, num_heads)  # this rank's [start, stop) of the heads (parallel.tensor)
        self.attn_drop, self.proj_drop = attn_drop, proj_drop
        self.relative_position_bias_table = nn.Parameter(
            trunc_normal_(torch.empty((2 * window_size - 1) ** 2, num_heads), 0.02))
        self.qkv = QuantLinear(dim, 3 * dim, use_bias=qkv_bias)
        self.qact1 = QuantAct(8)
        self.qact_attn1 = QuantAct(8)
        self.qact_table = QuantAct(8)
        self.qact2 = QuantAct(8)
        self.int_softmax = IntSoftmax(out_bits=8)
        self.qact3 = QuantAct(8)
        self.proj = QuantLinear(dim, dim)
        self.qact4 = QuantAct(16)

    def forward(self, x: QTensor, mask: torch.Tensor | None = None, train: bool = False,
                generator: torch.Generator | None = None) -> QTensor:
        """``x``: (B·nW, N, C) windows; ``mask``: the (nW, N, N) shifted-
        window mask of {0, −100} on x's device, or None."""
        Bw, N, C = x.shape
        (h0, h1), D = self.heads, self.head_dim
        H = h1 - h0
        dev = x.q.device
        qkv = self.qact1(self.qkv(x), update_stats=train)
        parts = qkv.q.reshape(Bw, N, 3, H, D).permute(2, 0, 3, 1, 4)  # 3 × (Bw, H, N, D)
        v_scale = qkv.scale

        scores = exact_int_matmul(parts[0], parts[1].transpose(-1, -2))
        attn = QTensor(scores, qkv.scale * qkv.scale * f32(D**-0.5, dev), 32)
        attn = self.qact_attn1(attn, update_stats=train)

        # the table is quantized whole (its range covers every head), then
        # cut to this rank's heads
        table = self.qact_table(self.relative_position_bias_table, update_stats=train)
        bias = QTensor(gather_bias(table.q, self.window_size)[h0:h1][None].expand(attn.shape), table.scale, 8)
        attn = self.qact2(attn, identity=bias, update_stats=train)

        # the mask in the integer domain: the reference adds the real −100
        # before the softmax divides by the scale, so mask/scale here
        if mask is not None:
            nW = mask.shape[0]
            mask_int = div(mask, attn.scale.detach())[None, :, None]  # (1, nW, 1, N, N)
            attn = attn.replace(q=(attn.q.reshape(Bw // nW, nW, H, N, N) + mask_int).reshape(Bw, H, N, N))

        attn = self.int_softmax(attn)
        if train and self.attn_drop > 0.0:
            attn = quant_dropout(attn, self.attn_drop, generator, ((1, self.num_heads, h0),))

        out = exact_int_matmul(attn.q, parts[2]).permute(0, 2, 1, 3).reshape(Bw, N, H * D)
        out = self.qact3(QTensor(out, attn.scale * v_scale, 32), update_stats=train)
        out = self.qact4(self.proj(out), update_stats=train)
        if train and self.proj_drop > 0.0:
            out = quant_dropout(out, self.proj_drop, generator)
        return out


class SwinBlock(nn.Module):
    """Shifted-window block on the (B, L, C) token stream: norm1 → qact →
    cyclic shift → windows → attention → reverse → the residual merged
    in the 16-bit ``qact2`` → norm2 → qact → Mlp → the residual merged in
    the 16-bit ``qact4``. The window is clamped to the grid, with no
    shift when one window covers it."""

    def __init__(self, dim: int, input_resolution: tuple, num_heads: int, window_size: int = 7,
                 shift_size: int = 0, mlp_ratio: float = 4.0, qkv_bias: bool = True, drop: float = 0.0,
                 attn_drop: float = 0.0, drop_path_rate: float = 0.0, gelu_stable: bool = False):
        super().__init__()
        Hr, Wr = input_resolution
        ws, shift = window_size, shift_size
        if min(Hr, Wr) <= ws:
            ws, shift = min(Hr, Wr), 0
        if Hr % ws or Wr % ws:
            raise ValueError(f"stage resolution {Hr}x{Wr} not divisible by window {ws}; pick img_size/patch_size/"
                             f"window_size so every stage divides (224/4 gives 56, 28, 14, 7 for window 7)")
        self.input_resolution, self.ws, self.shift = (Hr, Wr), ws, shift
        self.drop_path_rate = drop_path_rate
        self.norm1 = IntLayerNorm(dim)
        self.qact1 = QuantAct(8)
        self.attn = WindowAttention(dim, ws, num_heads, qkv_bias=qkv_bias, attn_drop=attn_drop, proj_drop=drop)
        self.qact2 = QuantAct(16)
        self.norm2 = IntLayerNorm(dim)
        self.qact3 = QuantAct(8)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim, drop=drop, gelu_stable=gelu_stable)
        self.qact4 = QuantAct(16)

    def forward(self, x1: QTensor, train: bool = False, generator: torch.Generator | None = None) -> QTensor:
        (Hr, Wr), ws, shift = self.input_resolution, self.ws, self.shift
        B, L, C = x1.shape
        x = self.qact1(self.norm1(x1), update_stats=train)
        g = x.q.reshape(B, Hr, Wr, C)
        if shift:
            g = torch.roll(g, (-shift, -shift), dims=(1, 2))
        xw = QTensor(window_partition(g, ws), x.scale, 8)
        aw = self.attn(xw, _mask_on(Hr, Wr, ws, shift, x.q.device), train, generator)

        g = window_reverse(aw.q, ws, Hr, Wr)
        if shift:
            g = torch.roll(g, (shift, shift), dims=(1, 2))
        a = QTensor(g.reshape(B, L, C), aw.scale, 16)
        if train:
            a = drop_path(a, self.drop_path_rate, generator)
        x2 = self.qact2(a, identity=x1, update_stats=train)

        y = self.qact3(self.norm2(x2), update_stats=train)
        y = self.mlp(y, train, generator)
        if train:
            y = drop_path(y, self.drop_path_rate, generator)
        return self.qact4(y, identity=x2, update_stats=train)


class PatchMerging(nn.Module):
    """2×2 downsample: the neighbourhood gather in the reference's concat
    order → I-LayerNorm over 4C → qact → bias-free 4C→2C ``reduction`` →
    qact."""

    def __init__(self, input_resolution: tuple, dim: int):
        super().__init__()
        self.input_resolution = input_resolution
        self.norm = IntLayerNorm(4 * dim)
        self.qact1 = QuantAct(8)
        self.reduction = QuantLinear(4 * dim, 2 * dim, use_bias=False)
        self.qact2 = QuantAct(8)

    def forward(self, x: QTensor, train: bool = False) -> QTensor:
        Hr, Wr = self.input_resolution
        B, L, C = x.shape
        g = x.q.reshape(B, Hr, Wr, C)
        q = torch.cat([g[:, 0::2, 0::2], g[:, 1::2, 0::2], g[:, 0::2, 1::2], g[:, 1::2, 1::2]], -1)
        y = self.qact1(self.norm(x.replace(q=q.reshape(B, L // 4, 4 * C))), update_stats=train)
        return self.qact2(self.reduction(y), update_stats=train)


class SwinTransformer(nn.Module):
    """The hierarchical QAT Swin on NHWC float images; returns float
    logits: input ``QuantAct`` → patch embed → qact → patch norm → qact
    (16 bits) → [absolute position embedding merged in a 16-bit
    ``QuantAct``] → stages of ``SwinBlock``s, each but the last ending in
    a ``PatchMerging`` → I-LayerNorm → qact → token-mean pool → qact →
    quantized head, whose output is the only dequantization.

    ``gelu_stable`` selects the elementwise ShiftGELU (the artifact
    records it); ``drop_rate``, ``attn_drop_rate`` and
    ``drop_path_rate`` (stochastic depth, rising linearly over the
    blocks) act only under ``train=True``. ``remat`` recomputes each
    ``SwinBlock`` in the backward (module docstring).
    """

    def __init__(
        self,
        img_size: int = 224,
        patch_size: int = 4,
        in_chans: int = 3,
        num_classes: int = 1000,
        embed_dim: int = 96,
        depths=(2, 2, 6, 2),
        num_heads=(3, 6, 12, 24),
        window_size: int = 7,
        mlp_ratio: float = 4.0,
        qkv_bias: bool = True,
        drop_rate: float = 0.0,
        attn_drop_rate: float = 0.0,
        drop_path_rate: float = 0.1,
        ape: bool = False,
        remat: bool = False,
        gelu_stable: bool = False,
    ):
        super().__init__()
        self.remat = remat
        self.config = swin_config(img_size, patch_size, num_classes, embed_dim, depths, num_heads, window_size,
                                  mlp_ratio, gelu_stable)
        self.ape = ape
        grid = img_size // patch_size
        self.qact_input = QuantAct(8)
        self.patch_embed = QuantPatchEmbed(patch_size, in_chans, embed_dim)
        self.qact_before_norm = QuantAct(8)
        self.patch_norm = IntLayerNorm(embed_dim)
        self.qact_embed = QuantAct(16)
        if ape:
            self.absolute_pos_embed = nn.Parameter(trunc_normal_(torch.empty(1, grid * grid, embed_dim), 0.02))
            self.qact_pos = QuantAct(16)
        self.qact1 = QuantAct(16)

        # flax's names (layers_{i}_blocks_{j}, layers_{i}_downsample)
        rates = iter(float(r) for r in np.linspace(0.0, drop_path_rate, sum(depths)))
        self.layers = []
        for i, depth in enumerate(depths):
            dim, res = embed_dim * 2**i, (grid // 2**i, grid // 2**i)
            for j in range(depth):
                blk = SwinBlock(dim, res, num_heads[i], window_size, 0 if j % 2 == 0 else window_size // 2,
                                mlp_ratio, qkv_bias, drop_rate, attn_drop_rate, next(rates), gelu_stable)
                self.add_module(f"layers_{i}_blocks_{j}", blk)
                self.layers.append(blk)
            if i < len(depths) - 1:
                merge = PatchMerging(res, dim)
                self.add_module(f"layers_{i}_downsample", merge)
                self.layers.append(merge)
        nf = embed_dim * 2 ** (len(depths) - 1)
        self.norm = IntLayerNorm(nf)
        self.qact2 = QuantAct(8)
        self.qact3 = QuantAct(8)
        self.head = QuantLinear(nf, num_classes)
        self.tp = None  # the parallel.tensor.TensorParallel of a tensor-parallel model

    def forward(self, images: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        x = self.qact_input(images, update_stats=train)
        x = self.qact_before_norm(self.patch_embed(x), update_stats=train)
        x = self.qact_embed(self.patch_norm(x), update_stats=train)
        if self.ape:
            pos = self.qact_pos(self.absolute_pos_embed, update_stats=train)
            x = self.qact1(x, identity=pos.replace(q=pos.q.expand(x.q.shape)), update_stats=train)
        else:
            x = self.qact1(x, update_stats=train)

        for layer in self.layers:
            if not isinstance(layer, SwinBlock):
                x = layer(x, train)
            elif self.remat:
                x = remat_block(layer, x, train, generator)
            else:
                x = layer(x, train, generator)

        x = self.qact2(self.norm(x), update_stats=train)
        # the token-mean pool: a fractional carrier that qact3 re-rounds
        x = self.qact3(x.replace(q=token_mean(x.q)), update_stats=train)
        return head_logits(self.head, x)
