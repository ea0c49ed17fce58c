"""Transformer building blocks: Mlp, Attention, Block.

Counterpart of ``ivit_tpu/nn/vit_blocks.py``, wired in the same order of
``QuantAct``s: every residual add is a dual-scale merge inside a 16-bit
``QuantAct``. Submodules keep flax's names, so a parameter's torch name
is its flax path with ``.`` for ``/`` (``nn.flax_state``).

Dropout and stochastic depth draw their masks from an explicit
``torch.Generator`` on the activations' device (the global generator
when it is None).
"""

from __future__ import annotations

import torch
from torch import nn

from ..core.qtensor import QTensor
from ..ops.interp import div, f32
from .quant import IntGELU, IntLayerNorm, IntSoftmax, QuantAct, QuantLinear, current_shard, quant_matmul


def keep_mask(shape, keep: float, generator: torch.Generator | None, device) -> torch.Tensor:
    """A float32 0/1 mask, each entry 1 with probability ``keep``
    (``jax.random.bernoulli``: uniform < keep). ``shape`` leads with the
    batch; inside ``nn.quant.data_shard`` the mask is drawn for the
    global batch and this shard's rows are kept, so every rank's
    generator makes the same draws as the single-process step's."""
    shard = current_shard()
    if shard is None:
        return (torch.rand(shape, generator=generator, device=device) < keep).to(torch.float32)
    b = shape[0]
    u = torch.rand((b * shard.size, *shape[1:]), generator=generator, device=device)
    return (u[shard.rank * b:(shard.rank + 1) * b] < keep).to(torch.float32)


def quant_dropout(x: QTensor, rate: float, generator: torch.Generator | None = None, split=()) -> QTensor:
    """Dropout that keeps the carrier integral: the 0/1 mask hits ``q``
    and the 1/keep rescale folds into the scale (the same expected value
    as float dropout; the exact int8 dots downstream need integers).
    ``split`` names the dimensions of which a tensor-parallel rank holds a
    slice, ``(dim, whole size, start)`` each (heads, columns, tokens): the
    mask is drawn whole along them and the rank keeps its slice."""
    keep = 1.0 - rate
    shape, index = list(x.q.shape), [slice(None)] * x.q.ndim
    for dim, size, start in split:
        shape[dim], index[dim] = size, slice(start, start + x.q.shape[dim])
    mask = keep_mask(tuple(shape), keep, generator, x.q.device)[tuple(index)]
    return QTensor(x.q * mask, x.scale * f32(1.0 / keep, x.q.device), x.bits)


def drop_path(x: QTensor, rate: float, generator: torch.Generator | None = None) -> QTensor:
    """Stochastic depth on the carrier: each sample's branch kept with
    probability 1 − rate and scaled by 1/keep (the requant after it
    restores integers)."""
    if rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = keep_mask((x.shape[0],) + (1,) * (x.q.ndim - 1), keep, generator, x.q.device)
    return x.replace(q=div(x.q * mask, keep))


def head_logits(head: QuantLinear, x: QTensor) -> torch.Tensor:
    """The dequantized logits of ``head`` on ``x``; a head split by
    classes (``parallel.tensor``) gathers them over the model axis."""
    logits = head(x).dequantize()
    return logits if head.split is None else head.split.axis.gather_last(logits)


def token_split(layer) -> tuple:
    """``quant_dropout``'s ``split`` for a (B, N, C) output of ``layer``'s
    row-parallel ``split`` (a ``QuantLinear``): this rank's tokens under
    sequence parallelism, else nothing."""
    split = layer.split
    if split is None or not split.seq:
        return ()
    return ((1, split.axis.tokens, split.axis.token_bounds()[0]),)


class Mlp(nn.Module):
    """fc1 → qact → ShiftGELU → qact → fc2 → qact(16 bits)."""

    def __init__(self, in_features: int, hidden_features: int, out_features: int, drop: float = 0.0,
                 gelu_stable: bool = False):
        super().__init__()
        self.drop, self.hidden_features = drop, hidden_features
        self.hidden = (0, hidden_features)  # this rank's [start, stop) of the hidden columns (parallel.tensor)
        self.fc1 = QuantLinear(in_features, hidden_features)
        self.qact_gelu = QuantAct(8)
        self.act = IntGELU(out_bits=8, stable=gelu_stable)
        self.qact1 = QuantAct(8)
        self.fc2 = QuantLinear(hidden_features, out_features)
        self.qact2 = QuantAct(16)

    def forward(self, x: QTensor, train: bool = False, generator: torch.Generator | None = None) -> QTensor:
        x = self.qact_gelu(self.fc1(x), update_stats=train)
        x = self.qact1(self.act(x), update_stats=train)
        if train and self.drop > 0.0:
            x = quant_dropout(x, self.drop, generator, ((x.q.ndim - 1, self.hidden_features, self.hidden[0]),))
        x = self.qact2(self.fc2(x), update_stats=train)
        if train and self.drop > 0.0:
            x = quant_dropout(x, self.drop, generator, token_split(self.fc2))
        return x


class Attention(nn.Module):
    """Quantized multi-head self-attention: qkv → qact → head split →
    exact q·kᵀ with 1/√d folded into the scale → qact → Shiftmax →
    exact attn·v → qact → proj → qact(16 bits)."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True, attn_drop: float = 0.0,
                 proj_drop: float = 0.0, softmax_bits: int = 16):
        super().__init__()
        self.num_heads, self.attn_drop, self.proj_drop = num_heads, attn_drop, proj_drop
        self.head_dim = dim // num_heads
        self.heads = (0, num_heads)  # this rank's [start, stop) of the heads (parallel.tensor)
        self.qkv = QuantLinear(dim, 3 * dim, use_bias=qkv_bias)
        self.qact1 = QuantAct(8)
        self.qact_attn1 = QuantAct(8)
        self.int_softmax = IntSoftmax(out_bits=softmax_bits)
        self.qact2 = QuantAct(8)
        self.proj = QuantLinear(dim, dim)
        self.qact3 = QuantAct(16)

    def forward(self, x: QTensor, train: bool = False, generator: torch.Generator | None = None) -> QTensor:
        H, D = self.heads[1] - self.heads[0], self.head_dim
        qkv = self.qact1(self.qkv(x), update_stats=train)  # under sequence parallelism qkv gathers the tokens
        B, N = qkv.shape[:2]
        parts = qkv.q.reshape(B, N, 3, H, D).permute(2, 0, 3, 1, 4)  # 3 × (B, H, N, D)
        q = QTensor(parts[0], qkv.scale, 8)
        k = QTensor(parts[1], qkv.scale, 8)
        v = QTensor(parts[2], qkv.scale, 8)

        attn = quant_matmul(q, k.transpose(0, 1, 3, 2))
        attn = attn.replace(scale=attn.scale * (D**-0.5))  # 1/√d in the scale only
        attn = self.int_softmax(self.qact_attn1(attn, update_stats=train))
        if train and self.attn_drop > 0.0:
            attn = quant_dropout(attn, self.attn_drop, generator, ((1, self.num_heads, self.heads[0]),))

        out = quant_matmul(attn, v)
        out = out.replace(q=out.q.permute(0, 2, 1, 3).reshape(B, N, H * D))
        out = self.qact3(self.proj(self.qact2(out, update_stats=train)), update_stats=train)
        if train and self.proj_drop > 0.0:
            out = quant_dropout(out, self.proj_drop, generator, token_split(self.proj))
        return out


class Block(nn.Module):
    """Pre-norm residual block; the residual adds happen inside the
    16-bit ``qact2`` and ``qact4`` as dual-scale merges."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 drop: float = 0.0, attn_drop: float = 0.0, drop_path_rate: float = 0.0,
                 softmax_bits: int = 16, gelu_stable: bool = False):
        super().__init__()
        self.drop_path_rate = drop_path_rate
        self.norm1 = IntLayerNorm(dim)
        self.qact1 = QuantAct(8)
        self.attn = Attention(dim, num_heads, qkv_bias=qkv_bias, attn_drop=attn_drop, proj_drop=drop,
                              softmax_bits=softmax_bits)
        self.qact2 = QuantAct(16)
        self.norm2 = IntLayerNorm(dim)
        self.qact3 = QuantAct(8)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim, drop=drop, gelu_stable=gelu_stable)
        self.qact4 = QuantAct(16)

    def forward(self, x1: QTensor, train: bool = False, generator: torch.Generator | None = None) -> QTensor:
        x = self.qact1(self.norm1(x1), update_stats=train)
        x = self.attn(x, train, generator)
        if train:
            x = drop_path(x, self.drop_path_rate, generator)
        x2 = self.qact2(x, identity=x1, update_stats=train)

        y = self.qact3(self.norm2(x2), update_stats=train)
        y = self.mlp(y, train, generator)
        if train:
            y = drop_path(y, self.drop_path_rate, generator)
        return self.qact4(y, identity=x2, update_stats=train)
