"""Integer-only ViT inference engine (PyTorch).

Counterpart of ``ivit_tpu/deploy/engine.py:build_vit_infer``: the
pure-XLA path's arithmetic, with the JAX engine's kernel selection
(``pallas_ops``) as ``kernels=``, by the same names:

* ``"layernorm"``: every I-LayerNorm → requant runs through K3
  (``kernels.fused_layernorm_requant``), 2·depth + 1 launches a forward;
* ``"attention"``: every attention (int8 Q·Kᵀ → requant → Shiftmax →
  @V → requant) runs through K1 (``kernels.fused_int8_attention``);
* ``"attention2"``: the same chain through K2
  (``kernels.fused_int8_attention_v2``, v2's value semantics);
* ``"softmax"``: int8 Q·Kᵀ, then K6 (``kernels.fused_requant_shiftmax``)
  into the base-256 (hi, lo) split, then two @V products and the rank-1
  ``128·Σv`` term, exact;
* ``"linear_gelu"``: the fc1 GEMM with the requant → row-max ShiftGELU
  → requant chain as its epilogue, K4 (``kernels.fused_linear_shiftgelu``);
* ``"gelu"``: the fc1 GEMM, then that chain through K5
  (``kernels.fused_requant_shiftgelu``);
* ``"gelu_stable"``: the fc1 GEMM, then its bias add → requant → stable
  ShiftGELU → requant chain through K9
  (``kernels.fused_requant_stable_gelu``), one lookup an element in the
  block's 256-entry table (``kernels.stable_gelu_table``, filled at
  build time by the plain chain on the engine's device). The JAX engine
  has no such kernel; K9 is the port's own.

Each attention and GELU kernel launches depth times a forward, at every
batch size. The default is ``("attention", "layernorm")``. K9 needs no
name: it runs wherever the model has ``gelu_stable`` and any kernel is
asked for, and ``infer.kernels`` then holds ``"gelu_stable"``; naming it
is accepted too. ``kernels=()`` stays the plain path. Precedence is
the JAX engine's (``ivit_tpu/deploy/engine.py:204-209``): ``attention``
over ``attention2`` over ``softmax``, and ``linear_gelu`` over ``gelu``.
Where one of JAX's gates would turn a requested kernel off, the engine
raises ``ValueError`` at build time instead, so that a launch count
proves each requested kernel ran: ``softmax`` at 8-bit probabilities
(it splits 16-bit ones); either row-max GELU kernel under
``gelu_stable``, and K9's name on a row-max model; more than 256 tokens
with any attention kernel (the exact row-sum bound); and, with
``attention2``, a block whose softmax input scale fails K2's gate.

JAX's ``attn_v_mode`` has no counterpart: "f32" and "exact" give the
same integers (a row's probabilities sum to less than 2^15 and
|v| ≤ 128, so every partial sum of the @V stays below 2^22, exact in
float32 in any order), and the plain path runs one exact @V for both.

The GEMMs (patch embed, qkv, proj, fc1 outside K4, fc2, head) lie
outside every Pallas kernel in JAX too (XLA int8 ``dot_general``); here
they are ``torch._int_mm`` (int8 → int32) with their requant and
residual epilogues as plain tensor ops. So are the ``softmax`` route's
Q·Kᵀ and @V products, in float64 (exact: |q·k| ≤ 2^20, and each @V
partial sum is below 2^22): torch has no batched int8 matmul on CUDA,
and a float32 product could run in TF32. The residual stream is int16.
The only float op is the final logit dequantization.

``strict_dyadic=True`` is the JAX engine's integer-ISA mode
(``ivit_tpu/deploy/engine.py:184-197``): every requant the JAX engine
routes through ``rq`` — patch embed, qkv, the attention scores and
context, proj, fc1, the GELU output and fc2 (``:381, 511, 592, 622, 711,
735, 740, 771``; ``:305-355`` and ``:674`` belong to paths the port does
not have) — becomes the exact dyadic multiply and shift of
``core.dyadic``; the LayerNorm requants and the residual merges stay
float32, as in JAX. The kernels requant in float32 inside, so JAX runs
strict mode without Pallas; here strict mode with any ``kernels=``
raises ``ValueError`` (a requested kernel never silently disappears),
and it runs with ``kernels=()``.

Entry points run on the card unless the caller passes ``device="cpu"``,
where each kernel's wrapper runs its plain version. Not ported: the TPU
layout/HBM probes and XLA barriers.
"""

from __future__ import annotations

import torch

from ..kernels import (
    fused_int8_attention,
    fused_int8_attention_reference,
    fused_int8_attention_v2,
    fused_layernorm_requant,
    fused_layernorm_requant_reference,
    fused_linear_shiftgelu,
    fused_requant_shiftgelu,
    fused_requant_shiftmax,
    fused_requant_stable_gelu,
    stable_gelu_table,
)
from ..core.dyadic import dyadic_decompose
from ..kernels.attention_fused import MAX_TOKENS, SHIFTMAX_N
from ..kernels.attention_fused_v2 import scale_gate
from ..ops import INT8, INT16, requant, shiftgelu, shiftmax
from ..ops.interp import div, f32
from ..ops.intmm import int8_matmul
from ..utils.spans import Span
from .artifact import artifact_to_torch

KERNEL_NAMES = ("attention", "attention2", "softmax", "gelu", "linear_gelu", "layernorm", "gelu_stable")
DEFAULT_KERNELS = ("attention", "layernorm")
_ATTENTION_KERNELS = {"attention", "attention2", "softmax"}
# the stages of a forward (utils/spans.py), shared with deploy/swin_engine.py
EMBED, ATTENTION, MLP, HEAD = (Span(f"engine.{stage}") for stage in ("embed", "attention", "mlp", "head"))

def select_kernels(cfg: dict, kernels=DEFAULT_KERNELS) -> frozenset:
    """The kernels a model of config ``cfg`` runs when ``kernels`` are
    asked for: the JAX engine's precedence; raises ``ValueError`` where a
    gate turns a requested kernel off (module docstring)."""
    unknown = set(kernels) - set(KERNEL_NAMES)
    if unknown:
        raise ValueError(f"unknown kernels {sorted(unknown)}; known: {KERNEL_NAMES}")
    on = set(kernels)
    if "attention" in on:
        on -= {"attention2", "softmax"}
    elif "attention2" in on:
        on.discard("softmax")
    if "linear_gelu" in on:
        on.discard("gelu")
    if "softmax" in on and int(cfg["softmax_bits"]) == 8:
        raise ValueError("softmax: K6 splits 16-bit probabilities; this model has softmax_bits=8")
    gelus = sorted(on & {"gelu", "linear_gelu"})
    if gelus and cfg["gelu_stable"]:
        raise ValueError(f"{gelus}: the GELU kernels run the row-max ShiftGELU; this model has gelu_stable=True")
    if "gelu_stable" in on and not cfg["gelu_stable"]:
        raise ValueError("gelu_stable: K9 runs the stable ShiftGELU; this model has gelu_stable=False (row max)")
    if on and cfg["gelu_stable"]:
        on.add("gelu_stable")
    n_tokens = (cfg["img_size"] // cfg["patch_size"]) ** 2 + 1
    if on & _ATTENTION_KERNELS and n_tokens > MAX_TOKENS:
        raise ValueError(
            f"N={n_tokens} tokens exceeds the fused attention bound of {MAX_TOKENS} "
            f"(kernels {sorted(on & _ATTENTION_KERNELS)})"
        )
    return frozenset(on)


def int8_linear(x: torch.Tensor, layer: dict, bias: bool = True) -> torch.Tensor:
    """(M, K) int8 @ w (K, N) int8 [+ b] → (M, N) int32, exact, through
    ``ops.intmm.int8_matmul``; the bias is added where the layer has one
    (Swin's patch-merging ``reduction`` has none). A ``w`` carried
    zero-padded to multiples of 8 (``artifact.carry_linear``, which sets
    the true N as ``n``) is cut back to N.

    A layer carried as one rank's tensor-parallel shard
    (``parallel.tp_infer``) may also hold ``cols``, the (start, stop) of
    x's columns its row block multiplies; ``reduce``, which sums the
    partial products over the model group before the bias is added once;
    and ``gather``, which joins the column blocks of the group after it.
    ``bias=False`` leaves the bias to the caller's epilogue (K9), which
    adds it after any ``reduce``; a ``gather`` needs it added before."""
    if "cols" in layer:
        x = x[:, slice(*layer["cols"])].contiguous()
    acc = int8_matmul(x, layer["w"], layer.get("n"))
    if "reduce" in layer:
        acc = layer["reduce"](acc)
    if "b" in layer and bias:
        acc = acc + layer["b"]
    return layer["gather"](acc) if "gather" in layer else acc


def _layernorm(x: torch.Tensor, norm: dict, kernels: frozenset) -> torch.Tensor:
    fn = fused_layernorm_requant if "layernorm" in kernels else fused_layernorm_requant_reference
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


def attention_inputs(x: torch.Tensor, blk: dict, num_heads: int, kernels=DEFAULT_KERNELS):
    """LayerNorm → qkv GEMM → requant → head split of the int16 stream
    (B, N, C); returns contiguous int8 q, k, v of shape (B·H, N, hd)."""
    B, N, C = x.shape
    return qkv_heads(_layernorm(x.reshape(B * N, C), blk["norm1"], kernels), blk["qkv"], B, num_heads)


def qkv_heads(y: torch.Tensor, qkv: dict, B: int, num_heads: int):
    """qkv GEMM → requant → head split of int8 rows (B·N, C) holding B
    sequences; returns contiguous int8 q, k, v of shape (B·H, N, hd),
    where the qkv columns hold ``num_heads`` heads as (3, H, hd)."""
    z = requant(int8_linear(y, qkv), qkv["ratio"], *INT8).to(torch.int8)
    N, hd = y.shape[0] // B, z.shape[1] // (3 * num_heads)
    z = z.reshape(B, N, 3, num_heads, hd).permute(2, 0, 3, 1, 4).contiguous()
    z = z.view(3, B * num_heads, N, hd)
    return z[0], z[1], z[2]


def split_softmax_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, a: dict) -> torch.Tensor:
    """The ``"softmax"`` route on (G, N, hd) int8 q, k, v at 16-bit
    probabilities (``ivit_tpu/deploy/engine.py:473-497, 566-580``): int8
    Q·Kᵀ, K6 into (hi, lo), then ``256·hi@V + lo@V + 128·Σv`` exact in
    int32, and the int8 requant."""
    G, N, _ = q.shape
    vd = v.to(torch.float64)
    scores = torch.matmul(q.to(torch.float64), k.to(torch.float64).transpose(-1, -2))
    hi, lo = fused_requant_shiftmax(
        scores.to(torch.int32).view(G * N, N), a["r1"], a["scale"], N, out_bits=16
    )
    ctx_hi = torch.matmul(hi.view(G, N, N).to(torch.float64), vd).to(torch.int32)
    ctx_lo = torch.matmul(lo.view(G, N, N).to(torch.float64), vd).to(torch.int32)
    v_sum = v.to(torch.int32).sum(1, keepdim=True, dtype=torch.int32)
    ctx = 256 * ctx_hi + ctx_lo + 128 * v_sum
    return requant(ctx, a["ratio_out"], *INT8).to(torch.int8)


def dyadic_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, a: dict, bits: int) -> torch.Tensor:
    """The plain attention of (G, N, hd) int8 q, k, v with its two
    requants dyadic (``a["dyadic"]``, strict mode): int8 Q·Kᵀ → requant
    → Shiftmax → @V → requant, exact products in float64."""
    r1, r_out = a["dyadic"]
    attn = torch.matmul(q.to(torch.float64), k.to(torch.float64).transpose(-1, -2)).to(torch.int32)
    sm, _ = shiftmax(requant(attn, r1, *INT8), f32(a["scale"], q.device), out_bits=bits, n=SHIFTMAX_N)
    ctx = torch.matmul(sm.to(torch.float64), v.to(torch.float64)).to(torch.int32)
    return requant(ctx, r_out, *INT8).to(torch.int8)


def _attention(q, k, v, a: dict, bits: int, kernels: frozenset) -> torch.Tensor:
    if "dyadic" in a:
        return dyadic_attention(q, k, v, a, bits)
    if "attention" in kernels:
        return fused_int8_attention(q, k, v, a["r1"], a["scale"], a["r_out"], bits)
    if "attention2" in kernels:
        return fused_int8_attention_v2(q, k, v, a["r1"], a["scale"], a["r_out"], q.shape[1], bits)
    if "softmax" in kernels:
        return split_softmax_attention(q, k, v, a)
    return fused_int8_attention_reference(q, k, v, a["r1"], a["scale"], a["r_out"], bits)


def _mlp_hidden(y: torch.Tensor, blk: dict, cfg: dict, kernels: frozenset) -> torch.Tensor:
    """fc1 GEMM → requant → ShiftGELU → requant: the int8 fc2 input."""
    fc1, gelu = blk["fc1"], blk["gelu"]
    if "linear_gelu" in kernels:
        return fused_linear_shiftgelu(y, fc1["w_t"].T, fc1["b"], fc1["ratio"], gelu["s_in"], gelu["r2"])
    if "gelu_stable" in kernels:
        return fused_requant_stable_gelu(int8_linear(y, fc1, bias=False), fc1["b"], fc1["ratio"], gelu["table"])
    acc = int8_linear(y, fc1)
    if "gelu" in kernels:
        return fused_requant_shiftgelu(acc, fc1["ratio"], gelu["s_in"], gelu["r2"])
    g, _ = shiftgelu(requant(acc, fc1["ratio"], *INT8), gelu["scale"], out_bits=8,
                     stable=bool(cfg["gelu_stable"]))
    return requant(g, gelu["ratio"], *INT8).to(torch.int8)


def attention_half(x: torch.Tensor, blk: dict, cfg: dict, kernels=DEFAULT_KERNELS) -> torch.Tensor:
    """The attention half of a block on the int16 stream (B, N, C):
    returns the (B·N, C) int16 stream after the first residual."""
    B, N, C = x.shape
    H = blk["heads"]
    q, k, v = attention_inputs(x, blk, H, kernels)
    ctx = _attention(q, k, v, blk["attn"], int(cfg["softmax_bits"]), kernels)
    ctx = ctx.reshape(B, H, N, -1).permute(0, 2, 1, 3).reshape(B * N, -1)
    proj = blk["proj"]
    branch = requant(int8_linear(ctx, proj), proj["ratio"], *INT16)
    return _residual(branch, x.reshape(B * N, C), blk["res1"])


def mlp_half(h: torch.Tensor, blk: dict, cfg: dict, kernels=DEFAULT_KERNELS) -> torch.Tensor:
    """The MLP half of a block on the (M, C) int16 stream after the first
    residual: norm2 → fc1 → ShiftGELU → fc2 → the second residual."""
    g8 = _mlp_hidden(_layernorm(h, blk["norm2"], kernels), blk, cfg, kernels)
    fc2 = blk["fc2"]
    m = requant(int8_linear(g8, fc2), fc2["ratio"], *INT16)
    return _residual(m, h, blk["res2"])


def vit_block(x: torch.Tensor, blk: dict, cfg: dict, kernels=DEFAULT_KERNELS) -> torch.Tensor:
    """One pre-norm transformer block on the int16 stream (B, N, C)."""
    return mlp_half(attention_half(x, blk, cfg, kernels), blk, cfg, kernels).reshape(x.shape)


def _strict_ratios(t: dict) -> None:
    """Swap, in carried tensors ``t``, every ratio the JAX engine's
    strict mode requantizes through ``rq`` for its ``Dyadic`` pair (the
    module docstring lists them); the attention's two go under
    ``attn["dyadic"]``."""
    device = t["head"]["w"].device

    def dyadic(r):
        return dyadic_decompose(r if isinstance(r, torch.Tensor) else f32(r, device))

    t["patch_embed"]["ratio"] = dyadic(t["patch_embed"]["ratio"])
    for blk in t["blocks"]:
        for name in ("qkv", "proj", "fc1", "fc2", "gelu"):
            blk[name]["ratio"] = dyadic(blk[name]["ratio"])
        blk["attn"]["dyadic"] = (dyadic(blk["attn"]["r1"]), dyadic(blk["attn"]["r_out"]))


def engine_tensors(artifact: dict, device, kernels=DEFAULT_KERNELS, strict_dyadic: bool = False,
                   validate: bool = True) -> tuple[dict, frozenset]:
    """The carried tensors of ``artifact`` on ``device`` (with each
    block's K9 table, ``gelu["table"]``, where K9 runs) and the kernels
    the engine runs, with ``build_vit_infer``'s gates (it raises where
    they refuse); ``validate=False`` carries an artifact whose schema the
    caller has checked (a tensor-parallel shard)."""
    if strict_dyadic and kernels:
        raise ValueError(
            f"strict_dyadic requantizes in integers; the kernels {sorted(kernels)} requant in float32 "
            "inside: pass kernels=()"
        )
    t = artifact_to_torch(artifact, device, validate=validate)
    cfg = t["config"]
    active = select_kernels(cfg, kernels)
    if strict_dyadic:
        _strict_ratios(t)
    if "gelu_stable" in active:
        for blk in t["blocks"]:
            blk["gelu"]["table"] = stable_gelu_table(blk["gelu"]["scale"], blk["gelu"]["ratio"])
    if "attention2" in active:
        n_tokens = (cfg["img_size"] // cfg["patch_size"]) ** 2 + 1
        for i, blk in enumerate(t["blocks"]):
            if not scale_gate(n_tokens, blk["attn"]["scale"]):
                raise ValueError(
                    f"attention2: block {i}'s softmax input scale {blk['attn']['scale']} fails "
                    f"K2's gate N*ceil(1/scale)*2^15 < 2^31 at N={n_tokens}"
                )
    return t, active


def vit_forward(images: torch.Tensor, t: dict, kernels: frozenset) -> torch.Tensor:
    """The engine's forward on carried tensors ``t``: float32 NHWC images
    on ``t``'s device → logits, in the spans ``engine.embed``, then
    ``engine.attention`` and ``engine.mlp`` a block, then ``engine.head``."""
    cfg = t["config"]
    with EMBED:
        x = embed(images, t)
    for blk in t["blocks"]:
        with ATTENTION:
            h = attention_half(x, blk, cfg, kernels)
        with MLP:
            x = mlp_half(h, blk, cfg, kernels).reshape(x.shape)
    with HEAD:
        # final norm on the CLS rows only (row-wise: the other rows'
        # values never reach the head)
        y = _layernorm(x[:, 0].contiguous(), t["norm"], kernels)
        head = t["head"]
        return int8_linear(y, head).to(torch.float32) * head["out_scale"]


def build_vit_infer(artifact: dict, device="cuda", kernels=DEFAULT_KERNELS, strict_dyadic: bool = False):
    """Build the int8 inference function: NHWC float images → logits.

    ``artifact`` is a ``freeze_vit`` dict (numpy arrays). ``kernels``
    names the chains that run through hand-written kernels (module
    docstring); ``kernels=()`` is the plain path, the oracle, like the
    JAX engine's ``use_pallas=False``. ``strict_dyadic`` requantizes as
    the JAX engine's strict mode does, and needs ``kernels=()``. The
    engine runs on the card unless ``device`` says otherwise, and raises
    if there is none; on the CPU every kernel's wrapper runs its plain
    version. The kernels in use are ``infer.kernels``, its device
    ``infer.device``.
    """
    t, active = engine_tensors(artifact, device, kernels, strict_dyadic)

    @torch.inference_mode()
    def infer(images: torch.Tensor) -> torch.Tensor:
        return vit_forward(images.to(device=device, dtype=torch.float32), t, active)

    infer.tensors = t
    infer.kernels = active
    infer.device = torch.device(device)
    return infer
