"""The quantization-aware training step of the integer-only ViT/DeiT
(I-ViT, arXiv:2207.01405) in plain torch: the simulated-integer forward
with straight-through gradients, the soft-target loss, the gradients,
AdamW, and the batch augmentation (mixup or cutmix with smoothed
targets, timm's as DeiT trains with it).

The forward computes the engine's integers on float32 carriers. Floor,
round and clip pass the gradient straight through (the clip in the
residue form ``sg(clip(x)) + (x − sg(x))``), 2^k is exact in the forward
and has the exponential's gradient; each ``QuantAct`` moves its range
(min/max, momentum 0.95, the first batch assigns it) and requantizes at
the range's symmetric scale; each ``QuantLinear`` quantizes its weight
per output channel on every call. Integer dots run exactly in float64;
their backward is float32 matmuls with TF32 off (``Precision.tf32``
turns TF32 on, the lower-precision control). Stochastic depth draws a
0/1 mask a sample from the generator it is given, as ``uniform < keep``.

Parameters carry the flax paths as names (``blocks_3.attn.qkv.kernel``),
so a state from elsewhere loads by name. Nothing here comes from the
program under test.
"""

from __future__ import annotations

import contextlib
import math
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from .intops import I32_MAX, div, int_range, scalar, symmetric_scale, weight_scale

# ---- straight-through integer operators ----------------------------------------------


class _Round(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return torch.round(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _Floor(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return torch.floor(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _Exp2(torch.autograd.Function):
    """Exact 2^k forward; gradient (g·ln2)·2^k."""

    @staticmethod
    def forward(ctx, k):
        out = torch.bitwise_left_shift(k.to(torch.int32) + 127, 23).view(torch.float32)
        ctx.save_for_backward(out)
        return out

    @staticmethod
    def backward(ctx, g):
        (two_k,) = ctx.saved_tensors
        return g * 0.6931471805599453 * two_k


def rnd(x):
    return _Round.apply(x) if x.requires_grad else torch.round(x)


def flr(x):
    return _Floor.apply(x) if x.requires_grad else torch.floor(x)


def clip(x, lo, hi):
    clipped = torch.clamp(x, lo, hi)
    return clipped if not x.requires_grad else clipped.detach() + (x - x.detach())


def exp2(k):
    if k.requires_grad:
        return _Exp2.apply(k)
    return torch.bitwise_left_shift(k.to(torch.int32) + 127, 23).view(torch.float32)


def quantize(x, scale, bits):
    return clip(rnd(torch.div(x, scale.detach())), *int_range(bits))


def requantize(q, s_in, s_out, bits, identity_q=None, identity_scale=None):
    s_out = s_out.detach()
    out = rnd(q * div(s_in, s_out))
    if identity_q is not None:
        out = out + rnd(identity_q * div(identity_scale, s_out))
    return clip(out, *int_range(bits))


def int_exp_shift(q, scale, n):
    scale = scale.detach()
    q = q + flr(q / 2.0) - flr(q / 16.0)
    x0 = torch.floor(div(-1.0, scale))
    q = torch.maximum(q, n * x0)
    qt = flr(div(q, x0))
    r = q - x0 * qt
    return clip(flr((r - 2.0 * x0) * exp2(n - 1.0 - qt)), 0.0, I32_MAX)


def shiftmax(q, scale, out_bits):
    q = q - torch.amax(q, dim=-1, keepdim=True)
    e = int_exp_shift(q, scale, 15)
    hi = flr(e * (1.0 / 2.0**16))
    lo = e - hi * 2.0**16
    total = clip(hi.sum(-1, keepdim=True) * 2.0**16 + lo.sum(-1, keepdim=True), 1.0, I32_MAX)
    factor = flr(div(I32_MAX, total)) * (1.0 / 2.0 ** (32 - out_bits))
    return flr(e * factor), scalar(1.0 / 2.0 ** (out_bits - 1), q.device)


def shiftgelu(q, scale, stable: bool, out_bits: int = 8, n: int = 23):
    sig_scale = scale.detach() * 1.702
    if stable:
        e = int_exp_shift(torch.minimum(q, -q), sig_scale, n)
        x0 = torch.floor(div(-1.0, sig_scale))
        e0 = (-x0) * 2.0**n
        factor = flr(div(I32_MAX, clip(e + e0, 1.0, I32_MAX)))
        sig = flr(torch.where(q >= 0.0, e0, e) * factor / 2.0 ** (32 - out_bits))
    else:
        q_max = torch.amax(q, dim=-1, keepdim=True)
        e = int_exp_shift(q - q_max, sig_scale, n)
        e_max = int_exp_shift(-q_max, sig_scale, n)
        factor = flr(div(I32_MAX, clip(e + e_max, 1.0, I32_MAX)))
        sig = flr(e * factor / 2.0 ** (32 - out_bits))
    return q * sig, scale * (1.0 / 2.0 ** (out_bits - 1))


def int_layernorm(q, gamma, beta):
    """The exact integer statistics forward, the float twin's gradient."""
    d = q.shape[-1]
    if d > 1000:
        raise ValueError("the merged int32 statistics take rows of at most 1000")
    base = math.sqrt(d) / 2.0**30
    qd = q.detach().to(torch.int32)
    a, b = qd >> 8, qd & 255
    s_q = qd.sum(-1, keepdim=True, dtype=torch.int32)
    s_bb = (b * b).sum(-1, keepdim=True, dtype=torch.int32)
    s_t = (a * a * 128 + a * b).sum(-1, keepdim=True, dtype=torch.int32)
    sq2 = s_t.to(torch.float32) * 2.0**9 + s_bb.to(torch.float32)
    sum_f = s_q.to(torch.float32)
    mean_val = torch.round(div(sum_f, float(d)))
    var_val = torch.clamp(sq2 - 2.0 * mean_val * sum_f + d * mean_val * mean_val, min=0.0)
    q = q.to(torch.float32)
    mean_f = rnd(torch.mean(q, dim=-1, keepdim=True))
    y = q - (mean_val + (mean_f - mean_f.detach()))
    var_f = torch.sum(y * y, dim=-1, keepdim=True)
    var = var_val + (var_f - var_f.detach())
    k = torch.full_like(var, 2.0**16)
    for _ in range(10):
        k = flr((k + flr(div(var, k))) / 2.0)
    factor = flr(div(I32_MAX, torch.clamp(k, min=1.0)))
    y = flr(y * factor / 2.0)
    bias_int = torch.floor(div(div(beta, gamma).detach(), base))
    return y + bias_int, gamma * base


# ---- exact integer dots ------------------------------------------------------------------


class Precision:
    """Whether the dots' backward GEMMs run in TF32 (the control) or in
    float32 with TF32 off (what the configuration states)."""

    tf32 = False


@contextlib.contextmanager
def _matmul_precision():
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high" if Precision.tf32 else "highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def backward_matmul(a, b):
    with _matmul_precision():
        return torch.matmul(a, b)


class _Dot(torch.autograd.Function):
    """(..., K) @ (K, N) [+ b] of integer-valued float32, exact."""

    @staticmethod
    def forward(ctx, x, w, b):
        acc = torch.matmul(x.reshape(-1, x.shape[-1]).to(torch.float64), w.to(torch.float64))
        if b is not None:
            acc = acc + b.to(torch.float64)
        ctx.save_for_backward(x, w)
        ctx.has_bias = b is not None
        return acc.to(torch.float32).reshape(*x.shape[:-1], w.shape[1])

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1])
        return (backward_matmul(g, w.T), backward_matmul(x.reshape(-1, x.shape[-1]).T, g2),
                g2.sum(0) if ctx.has_bias else None)


class _Matmul(torch.autograd.Function):
    """Batched a @ b of integer-valued float32, exact."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.matmul(a.to(torch.float64), b.to(torch.float64)).to(torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        return backward_matmul(g, b.transpose(-1, -2)), backward_matmul(a.transpose(-1, -2), g)


# ---- layers ------------------------------------------------------------------------------


class Q(NamedTuple):
    q: torch.Tensor
    scale: torch.Tensor
    bits: int = 8

    def real(self):
        return self.q.to(torch.float32) * self.scale


class QuantAct(nn.Module):
    def __init__(self, bits: int):
        super().__init__()
        self.bits = bits
        self.register_buffer("min_val", torch.zeros((), dtype=torch.float32))
        self.register_buffer("max_val", torch.zeros((), dtype=torch.float32))

    def forward(self, x, identity: Q | None = None, update: bool = False) -> Q:
        is_q = isinstance(x, Q)
        real = x.real() if is_q else x.to(torch.float32)
        if identity is not None:
            real = real + identity.real()
        if update:
            with torch.no_grad():
                cur_min, cur_max = torch.aminmax(real.detach())
                first = self.min_val == self.max_val
                self.min_val.copy_(torch.where(first, cur_min, 0.95 * self.min_val + (1 - 0.95) * cur_min))
                self.max_val.copy_(torch.where(first, cur_max, 0.95 * self.max_val + (1 - 0.95) * cur_max))
        scale = symmetric_scale(self.min_val, self.max_val, self.bits).detach()
        if not is_q:
            return Q(quantize(real, scale, self.bits), scale, self.bits)
        iq = None if identity is None else identity.q
        iscale = None if identity is None else identity.scale
        return Q(requantize(x.q, x.scale, scale, self.bits, iq, iscale), scale, self.bits)


class QuantLinear(nn.Module):
    def __init__(self, k: int, n: int, bias: bool = True):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(k, n))
        self.bias = nn.Parameter(torch.zeros(n)) if bias else None

    def forward(self, x: Q) -> Q:
        w_scale = weight_scale(self.kernel.T, 8).detach()
        w_int = quantize(self.kernel, w_scale, 8)
        out_scale = w_scale * x.scale.detach()
        b_int = None if self.bias is None else quantize(self.bias, out_scale, 32)
        return Q(_Dot.apply(x.q, w_int, b_int), out_scale, 32)


class IntLayerNorm(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d))
        self.bias = nn.Parameter(torch.zeros(d))

    def forward(self, x: Q) -> Q:
        q, s = int_layernorm(x.q, self.scale, self.bias)
        return Q(q, s, 32)


def keep_mask(shape, keep: float, generator, device):
    return (torch.rand(shape, generator=generator, device=device) < keep).to(torch.float32)


def drop_path(x: Q, rate: float, generator) -> Q:
    if rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = keep_mask((x.q.shape[0],) + (1,) * (x.q.ndim - 1), keep, generator, x.q.device)
    return x._replace(q=div(x.q * mask, keep))


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int, softmax_bits: int):
        super().__init__()
        self.heads, self.hd, self.bits = heads, dim // heads, softmax_bits
        self.qkv = QuantLinear(dim, 3 * dim)
        self.qact1 = QuantAct(8)
        self.qact_attn1 = QuantAct(8)
        self.qact2 = QuantAct(8)
        self.proj = QuantLinear(dim, dim)
        self.qact3 = QuantAct(16)

    def forward(self, x: Q, train: bool) -> Q:
        H, D = self.heads, self.hd
        qkv = self.qact1(self.qkv(x), update=train)
        B, N = qkv.q.shape[:2]
        parts = qkv.q.reshape(B, N, 3, H, D).permute(2, 0, 3, 1, 4)
        attn = Q(_Matmul.apply(parts[0], parts[1].permute(0, 1, 3, 2)), qkv.scale * qkv.scale, 32)
        attn = attn._replace(scale=attn.scale * (D**-0.5))
        a = self.qact_attn1(attn, update=train)
        sm_q, sm_s = shiftmax(a.q, a.scale, self.bits)
        out = Q(_Matmul.apply(sm_q, parts[2]), sm_s * qkv.scale, 32)
        out = out._replace(q=out.q.permute(0, 2, 1, 3).reshape(B, N, H * D))
        return self.qact3(self.proj(self.qact2(out, update=train)), update=train)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, stable: bool):
        super().__init__()
        self.stable = stable
        self.fc1 = QuantLinear(dim, hidden)
        self.qact_gelu = QuantAct(8)
        self.qact1 = QuantAct(8)
        self.fc2 = QuantLinear(hidden, dim)
        self.qact2 = QuantAct(16)

    def forward(self, x: Q, train: bool) -> Q:
        x = self.qact_gelu(self.fc1(x), update=train)
        q, s = shiftgelu(x.q, x.scale, self.stable)
        x = self.qact1(Q(q, s, 32), update=train)
        return self.qact2(self.fc2(x), update=train)


class Block(nn.Module):
    def __init__(self, dim: int, heads: int, hidden: int, rate: float, softmax_bits: int, stable: bool):
        super().__init__()
        self.rate = rate
        self.norm1 = IntLayerNorm(dim)
        self.qact1 = QuantAct(8)
        self.attn = Attention(dim, heads, softmax_bits)
        self.qact2 = QuantAct(16)
        self.norm2 = IntLayerNorm(dim)
        self.qact3 = QuantAct(8)
        self.mlp = Mlp(dim, hidden, stable)
        self.qact4 = QuantAct(16)

    def forward(self, x1: Q, train: bool, generator) -> Q:
        x = self.attn(self.qact1(self.norm1(x1), update=train), train)
        if train:
            x = drop_path(x, self.rate, generator)
        x2 = self.qact2(x, identity=x1, update=train)
        y = self.mlp(self.qact3(self.norm2(x2), update=train), train)
        if train:
            y = drop_path(y, self.rate, generator)
        return self.qact4(y, identity=x2, update=train)


class VisionTransformer(nn.Module):
    """The QAT ViT on NHWC float images; returns float logits."""

    def __init__(self, model: dict, drop_path_rate: float):
        super().__init__()
        D, p = model["embed_dim"], model["patch_size"]
        self.cfg = model
        n = (model["img_size"] // p) ** 2
        hidden = int(D * model["mlp_ratio"])
        self.qact_input = QuantAct(8)
        self.patch_embed = nn.Module()
        self.patch_embed.proj = QuantLinear(p * p * 3, D)
        self.qact_embed = QuantAct(16)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, D))
        self.pos_embed = nn.Parameter(torch.zeros(1, n + 1, D))
        self.qact_pos = QuantAct(16)
        self.qact1 = QuantAct(16)
        rates = np.linspace(0.0, drop_path_rate, model["depth"])
        self.blocks = []
        for i, rate in enumerate(rates):
            blk = Block(D, model["num_heads"], hidden, float(rate), int(model["softmax_bits"]),
                        bool(model["gelu_stable"]))
            self.add_module(f"blocks_{i}", blk)
            self.blocks.append(blk)
        self.norm = IntLayerNorm(D)
        self.qact2 = QuantAct(8)
        self.head = QuantLinear(D, model["num_classes"])

    def forward(self, images: torch.Tensor, train: bool = False, generator=None) -> torch.Tensor:
        B, _, _, C = images.shape
        p, D = self.cfg["patch_size"], self.cfg["embed_dim"]
        gh = self.cfg["img_size"] // p
        x = self.qact_input(images, update=train)
        q = x.q.reshape(B, gh, p, gh, p, C).permute(0, 1, 3, 2, 4, 5).reshape(B, gh * gh, p * p * C)
        x = self.qact_embed(self.patch_embed.proj(Q(q, x.scale, x.bits)), update=train)
        cls_q = rnd(div(self.cls_token, x.scale.detach())).expand(B, 1, D)
        x = x._replace(q=torch.cat([cls_q, x.q], dim=1))
        pos = self.qact_pos(self.pos_embed, update=train)
        x = self.qact1(x, identity=pos._replace(q=pos.q.expand(x.q.shape)), update=train)
        for blk in self.blocks:
            x = blk(x, train, generator)
        x = self.norm(x)
        x = self.qact2(x._replace(q=x.q[:, 0]), update=train)
        return self.head(x).real()


def soft_target_cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits.to(torch.float64), dim=-1)
    return (-targets.to(torch.float64) * logp).sum(-1).mean().to(torch.float32)


# ---- the optimizer and the step ------------------------------------------------------------


class AdamW:
    """Adam moments, bias corrections at the incremented count in float32,
    ``m̂/(√v̂ + eps)`` plus ``weight_decay · p``, times −lr (optax's
    ``adamw`` order)."""

    def __init__(self, params: list, lr: float, b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-4):
        self.params, self.lr, self.b1, self.b2, self.eps, self.wd = params, lr, b1, b2, eps, weight_decay
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.count = 0

    @torch.no_grad()
    def update(self, grads: list) -> None:
        b1, b2 = self.b1, self.b2
        self.count += 1
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, torch._foreach_mul(grads, 1 - b1))
        sq = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(sq, 1 - b2)
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_add_(self.nu, sq)
        one = np.float32(1.0)
        bc1 = float(one - np.float32(b1) ** np.float32(self.count))
        bc2 = float(one - np.float32(b2) ** np.float32(self.count))
        den = torch._foreach_div(self.nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        upd = torch._foreach_div(self.mu, bc1)
        torch._foreach_div_(upd, den)
        if self.wd:
            torch._foreach_add_(upd, torch._foreach_mul(self.params, self.wd))
        torch._foreach_mul_(upd, -self.lr)
        torch._foreach_add_(self.params, upd)


def train_step(model: VisionTransformer, opt: AdamW, images, targets, generator, half_batch: bool = False):
    """One step: forward with the ranges moving, the loss, the gradients,
    the update. ``half_batch`` is a planted fault (half of the batch left
    out, the mean over the rest), never the reference. Returns the loss."""
    if half_batch:
        images, targets = images[: images.shape[0] // 2], targets[: targets.shape[0] // 2]
    logits = model(images, train=True, generator=generator)
    loss = soft_target_cross_entropy(logits, targets)
    grads = list(torch.autograd.grad(loss, opt.params, materialize_grads=True))
    opt.update(grads)
    return loss.detach()


# ---- the batch augmentation ----------------------------------------------------------------


class Draws(NamedTuple):
    lam_mix: float
    use_cutmix: bool
    cy: int
    cx: int
    lam_cut: float


def draw_mixup(mixup_alpha, cutmix_alpha, switch_prob, h, w, rng: np.random.Generator) -> Draws:
    """The four draws of one batch, in order, from ``rng``."""
    f = np.float32
    return Draws(float(f(rng.beta(mixup_alpha, mixup_alpha))), bool(rng.random() < switch_prob),
                 int(rng.integers(0, h)), int(rng.integers(0, w)), float(f(rng.beta(cutmix_alpha, cutmix_alpha))))


def mixup(images, labels, classes: int, smoothing: float, d: Draws):
    """Mixup or cutmix of NHWC images with the batch reversed, and the
    smoothed one-hot targets mixed by the realized λ."""
    f = np.float32
    h, w = images.shape[1], images.shape[2]
    off = smoothing / classes
    one_hot = torch.nn.functional.one_hot(labels.long(), classes).to(torch.float32)
    targets = one_hot * float(f(1.0 - smoothing + off - off)) + float(f(off))
    flipped, flipped_t = images.flip(0), targets.flip(0)
    if d.use_cutmix:
        cut = np.sqrt(f(1.0) - f(d.lam_cut))
        ch, cw = int(f(h) * cut), int(f(w) * cut)
        y0, y1 = min(max(d.cy - ch // 2, 0), h), min(max(d.cy + ch // 2, 0), h)
        x0, x1 = min(max(d.cx - cw // 2, 0), w), min(max(d.cx + cw // 2, 0), w)
        out = images.clone()
        out[:, y0:y1, x0:x1] = flipped[:, y0:y1, x0:x1]
        lam = f(1.0) - f((y1 - y0) * (x1 - x0)) / f(h * w)
    else:
        lam = f(d.lam_mix)
        out = images * float(lam) + flipped * float(f(1.0) - lam)
    return out, targets * float(lam) + flipped_t * float(f(1.0) - lam)


def named_params(params: dict) -> dict:
    """``reference/vit.py``'s float parameters under the QAT model's names."""
    out = {"patch_embed.proj.kernel": params["patch_embed"][0], "patch_embed.proj.bias": params["patch_embed"][1],
           "cls_token": params["cls_token"], "pos_embed": params["pos_embed"],
           "norm.scale": params["norm"][0], "norm.bias": params["norm"][1],
           "head.kernel": params["head"][0], "head.bias": params["head"][1]}
    where = {"norm1": "norm1", "qkv": "attn.qkv", "proj": "attn.proj", "norm2": "norm2", "fc1": "mlp.fc1",
             "fc2": "mlp.fc2"}
    for i, blk in enumerate(params["blocks"]):
        for key, path in where.items():
            a, b = blk[key]
            first, second = ("scale", "bias") if key.startswith("norm") else ("kernel", "bias")
            out[f"blocks_{i}.{path}.{first}"], out[f"blocks_{i}.{path}.{second}"] = a, b
    return out
