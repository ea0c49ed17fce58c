"""Tensor-parallel serving of the frozen int8 engines.

Counterpart of ``ivit_tpu/parallel/tp_infer.py``. There GSPMD partitions
the engine's weight matrices over the ``model`` axis of the mesh by
Megatron's rules (qkv and fc1 column-parallel, proj and fc2
row-parallel, the head column-parallel) and inserts the int32 all-reduces.
Here each rank carries its own shard of the numpy artifact through the
port's ``artifact_to_torch`` and runs the ordinary engine on it, the
collectives held in the shard's layers (``deploy.engine.int8_linear``):

* **qkv by heads.** The engine splits qkv's columns as (3, H, hd)
  (``engine.qkv_heads``), so a rank's shard is the q, k and v columns of
  its H/n heads, with the same entries of the bias and of the requant
  ratio. Its shape is that of JAX's ``P(None, "model")`` shard
  (C, 3C/n), but its columns are not the contiguous block GSPMD takes
  (GSPMD reshards before the head split; the port does not).
* **Attention on a rank's heads.** K1, K2 and K6 take (B·H/n, N, hd)
  and K7 (B·nW·H/n, 49, hd) with the relative-position bias cut to the
  rank's heads.
* **proj and fc2 row-parallel.** Each rank forms its partial int32
  product, the model group sums it (exact), and the bias is added once
  after the sum; the requant and the residual run on full rows, as does
  every LayerNorm (K3), on every rank.
* **fc1 column-parallel.** Under ``gelu_stable`` the GELU is
  elementwise and each rank finishes its own columns (through K9, with
  the bias of its columns, wherever any kernel runs). The row-max
  ShiftGELU (the reference spec and every Swin) needs the whole 4C row:
  the int32 accumulator is all-gathered and the chain (K5 when
  ``"gelu"`` is asked for, else plain) runs on full rows, each rank then
  multiplying its own columns into fc2. K4 (``"linear_gelu"``) fuses the
  GEMM with that row max, which a column shard cannot see: it raises
  ``ValueError`` under a model axis above 1.
* **The head** is column-parallel, its logits all-gathered.

A layer whose heads (qkv, attention, proj), hidden width (fc1, fc2) or
classes (the head) the model axis does not divide runs replicated on
every rank (``parallel.mesh.splits``, the rule tensor-parallel training
follows too): DeiT-S's 6 heads at ``model = 4``, Swin-T's 3 stage-1
heads at 2. A rank's positions are ``parallel.mesh.split_positions``,
as the trainer's ``param_slices`` are. The values are the same; JAX's
shard shapes differ there, since JAX shards any evenly divisible
dimension. Every cross-rank reduction is an integer sum, so the logits
equal the single-process engine's bit for bit, and ``strict_dyadic``
works because its dyadic ratios are per channel. A ``data`` axis above 1 composes data parallelism: each data
row of the mesh serves its rows of the global batch.
"""

from __future__ import annotations

import numpy as np
import torch

from ..deploy.artifact import validate_artifact
from ..deploy.engine import build_vit_infer, engine_tensors, vit_forward
from ..deploy.swin_artifact import swin_artifact_to_torch, validate_swin_artifact
from ..deploy.swin_engine import build_swin_infer, select_swin_kernels, swin_forward
from .mesh import Mesh, split_positions, splits

# (path-suffix, spec) — first match wins; JAX's ``_TP_WEIGHT_RULES``
_TP_WEIGHT_RULES = (
    ("qkv/w", (None, "model")),
    ("qkv/b", ("model",)),
    ("proj/w", ("model", None)),
    ("fc1/w", (None, "model")),
    ("fc1/b", ("model",)),
    ("fc2/w", ("model", None)),
    ("head/w", (None, "model")),
    ("head/b", ("model",)),
)


def _blocks(artifact: dict):
    """(path, block, heads) of every transformer block of a ViT or Swin
    artifact."""
    if "stages" in artifact:
        for i, stage in enumerate(artifact["stages"]):
            for j, blk in enumerate(stage["blocks"]):
                yield f"stages/{i}/blocks/{j}", blk, blk["heads"]
    else:
        for i, blk in enumerate(artifact["blocks"]):
            yield f"blocks/{i}", blk, artifact["config"]["num_heads"]


def tp_weight_shardings(artifact: dict, n_model: int) -> dict:
    """The port's layout of ``artifact`` over a model axis of ``n_model``
    ranks: ``{path: (spec, shard shape)}`` for every weight and bias that
    JAX's rules name (paths as JAX's ``tp_weight_shardings`` forms them,
    e.g. ``blocks/0/qkv/w``). A layer the axis does not divide (module
    docstring) is replicated: spec ``()`` and the full shape."""
    out = {}

    def put(path, arr, split):
        spec = next(s for frag, s in _TP_WEIGHT_RULES if path.endswith(frag)) if split else ()
        shape = tuple(d // n_model if ax == "model" else d for d, ax in zip(arr.shape, spec)) or arr.shape
        out[path] = (spec, tuple(shape))

    for path, blk, heads in _blocks(artifact):
        attn, mlp = splits(heads, n_model), splits(blk["fc1"]["w"].shape[1], n_model)
        for name, split in (("qkv", attn), ("proj", attn), ("fc1", mlp), ("fc2", mlp)):
            for leaf in ("w", "b") if name in ("qkv", "fc1") else ("w",):
                put(f"{path}/{name}/{leaf}", np.asarray(blk[name][leaf]), split)
    head = artifact["head"]
    for leaf in ("w", "b"):
        put(f"head/{leaf}", np.asarray(head[leaf]), splits(head["w"].shape[1], n_model))
    return out


def _cols(arr, idx):
    return np.ascontiguousarray(np.take(np.asarray(arr), idx, axis=-1))


def _rows(arr, idx):
    return np.ascontiguousarray(np.take(np.asarray(arr), idx, axis=0))


def _shard_block(blk: dict, heads: int, n: int, m: int, row_max_gelu: bool) -> tuple[dict, dict]:
    """Rank ``m`` of ``n``'s shard of one block of a numpy artifact, and
    what the carried block needs besides: ``{"heads": local heads,
    "attn": split, "mlp": split, "cols": fc2's input columns or None}``.
    Under the row-max GELU fc1 keeps its full ``out_scale`` (the chain
    runs on gathered rows) and fc2 multiplies its rows' columns."""
    out, info = dict(blk), {"heads": heads, "attn": False, "mlp": False, "cols": None}
    if splits(heads, n):
        C = blk["qkv"]["w"].shape[0]
        out["qkv"] = {k: _cols(v, split_positions(3 * C, n, m, heads)) for k, v in blk["qkv"].items()}
        out["proj"] = dict(blk["proj"], w=_rows(blk["proj"]["w"], split_positions(C, n, m)))
        if "bias_req" in blk:
            out["bias_req"] = _rows(blk["bias_req"], split_positions(heads, n, m))
        info.update(heads=heads // n, attn=True)
    hidden = blk["fc1"]["w"].shape[1]
    if splits(hidden, n):
        cols = split_positions(hidden, n, m)
        keep = ("w", "b") if row_max_gelu else ("w", "b", "out_scale")
        out["fc1"] = {k: _cols(v, cols) if k in keep else v for k, v in blk["fc1"].items()}
        out["fc2"] = dict(blk["fc2"], w=_rows(blk["fc2"]["w"], cols))
        info.update(mlp=True, cols=(int(cols[0]), int(cols[-1]) + 1) if row_max_gelu else None)
    return out, info


def shard_artifact(artifact: dict, n: int, m: int) -> tuple[dict, list, bool]:
    """Rank ``m`` of ``n``'s shard of a ViT or Swin artifact (numpy),
    with each block's ``_shard_block`` info in order, and whether the head
    is split (its ``out_scale`` stays whole: the logits are gathered as
    int32 before it)."""
    row_max = not artifact["config"]["gelu_stable"]
    shard, infos = dict(artifact), []
    if "stages" in artifact:
        stages = []
        for stage in artifact["stages"]:
            blocks = []
            for blk in stage["blocks"]:
                b, info = _shard_block(blk, blk["heads"], n, m, row_max)
                blocks.append(b)
                infos.append(info)
            stages.append(dict(stage, blocks=blocks))
        shard["stages"] = stages
    else:
        blocks = []
        for blk in artifact["blocks"]:
            b, info = _shard_block(blk, artifact["config"]["num_heads"], n, m, row_max)
            blocks.append(b)
            infos.append(info)
        shard["blocks"] = blocks
    head = artifact["head"]
    split_head = splits(head["w"].shape[1], n)
    if split_head:
        cols = split_positions(head["w"].shape[1], n, m)
        shard["head"] = dict(head, w=_cols(head["w"], cols), b=_cols(head["b"], cols))
    return shard, infos, split_head


def _wire(t: dict, infos: list, split_head: bool, mesh: Mesh) -> None:
    """Put the model group's collectives into the carried shard ``t``'s
    layers (``engine.int8_linear``) and each block's local head count."""

    def reduce(acc):
        return mesh.all_reduce(acc, "model")

    def gather(acc):
        return mesh.all_gather(acc, "model", dim=1)

    blocks = [b for s in t["stages"] for b in s["blocks"]] if "stages" in t else t["blocks"]
    for blk, info in zip(blocks, infos):
        blk["heads"] = info["heads"]
        if info["attn"]:
            blk["proj"]["reduce"] = reduce
        if info["mlp"]:
            blk["fc2"]["reduce"] = reduce
            if info["cols"] is not None:
                blk["fc1"]["gather"] = gather
                blk["fc2"]["cols"] = info["cols"]
    if split_head:
        t["head"]["gather"] = gather


def shard_infer_tp(artifact: dict, mesh: Mesh, build_fn=None, **build_opts):
    """Tensor(×data)-parallel engine forward over a ``(data, model)``
    mesh: ``images (global batch) → logits``, equal bit for bit to the
    single-process engine (module docstring). Every rank of the mesh
    builds it and calls it with the same global batch, which must be
    divisible by ``mesh.shape['data']``.

    ``build_fn`` names the family as in JAX: ``deploy.build_vit_infer``
    (the default) or ``deploy.build_swin_infer``; ``build_opts`` are its
    ``kernels`` (and for the ViT ``strict_dyadic``); the device is the
    mesh's. Raises ``ValueError`` for ``"linear_gelu"`` (K4) under a
    model axis above 1, and where the engine's own gates do."""
    n, m = mesh.shape["model"], mesh.coords["model"]
    build_fn = build_fn or build_vit_infer
    device = mesh.device
    if build_fn is build_vit_infer:
        validate_artifact(artifact)
        kernels = build_opts.pop("kernels", ("attention", "layernorm"))
        if n > 1 and "linear_gelu" in kernels:
            raise ValueError("linear_gelu: K4 fuses the fc1 GEMM with a row max over all 4C columns, which a "
                             "model-axis shard cannot see; under tensor parallelism use route B "
                             "(kernels=('layernorm', 'softmax', 'gelu'))")
        shard, infos, split_head = shard_artifact(artifact, n, m)
        t, active = engine_tensors(shard, device, kernels, validate=False, **build_opts)
        forward = vit_forward
    elif build_fn is build_swin_infer:
        validate_swin_artifact(artifact)
        shard, infos, split_head = shard_artifact(artifact, n, m)
        t = swin_artifact_to_torch(shard, device, validate=False)
        active = select_swin_kernels(t["config"], build_opts.pop("kernels", ("attention", "layernorm")))
        if build_opts:
            raise TypeError(f"build_swin_infer takes no {sorted(build_opts)}")
        forward = swin_forward
    else:
        raise ValueError(f"build_fn {build_fn!r}: deploy.build_vit_infer or deploy.build_swin_infer")
    _wire(t, infos, split_head, mesh)

    @torch.inference_mode()
    def infer(images: torch.Tensor) -> torch.Tensor:
        local = mesh.block(images, "data").to(device=device, dtype=torch.float32)
        return mesh.all_gather(forward(local, t, active), "data")

    infer.tensors = t
    infer.kernels = active
    infer.device = device
    return infer
