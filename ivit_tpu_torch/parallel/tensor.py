"""Tensor-parallel QAT: a Megatron-style model axis in the train step,
with sequence parallelism.

Counterpart of JAX's ``param_shardings`` over a ``(data, model)`` mesh
(``ivit_tpu/parallel/mesh.py:33-42,173-201``) and of ``seq_constraint``.
There the layout alone makes GSPMD run the same global maths on every
device; here each rank is a process holding its slice of each split
parameter, and the layers call the model group's collectives themselves
(``parallel.mesh.ModelAxis``):

* **Attention by heads.** ``qkv`` is column-parallel, its columns taken
  in (3, H, hd) order as ``tp_infer`` takes them for serving; the rank
  runs its heads' scores, Shiftmax and attn·v; ``proj`` is row-parallel.
* **Mlp by hidden columns.** ``fc1`` column-parallel, ``fc2``
  row-parallel; the row-max ShiftGELU takes its max over the whole 4C
  row (a MAX over the group), the stable form needs nothing.
* **The head by classes**, its logits gathered for the loss.
* **Row-parallel products** are summed over the group as int32 before
  the bias is added and the float32 carrier formed; every per-channel
  weight range of a row-parallel kernel is a MAX over the group.
* **Ranges.** Every ``QuantAct`` range is a MIN/MAX over the whole world
  (``parallel.batch_shard``), whether the rank's tensor is a slice of
  heads, columns, tokens or batch rows or the whole tensor: MIN/MAX may
  repeat without harm, so one rule serves every layout.
* **Random draws.** Dropout and drop-path masks are drawn for the global
  tensor from the step's generator; each rank keeps its heads, columns,
  tokens and rows (``nn.vit_blocks.quant_dropout``).

Every sum across ranks in the forward is a sum of integers, so step 1's
logits, every range and every weight scale equal the single-process
step's bit for bit. The gradients differ from it by the order of the
backward's float32 sums (the all-reduces of ``ModelAxis.copy``).

A layer whose heads, hidden width or classes the axis does not divide
stays whole on every rank (``parallel.mesh.splits``, the rule serving
follows too: Swin-T's 3-head stage 1 at a model axis of 2), as do the
LayerNorms, ``PatchMerging`` and the embeddings. Swin's relative-position bias
table stays whole and is quantized whole, then each rank cuts its heads,
so its gradient is summed over the group.

**The float models** (``*_fp32``) split as JAX's rules split their
flat names: qkv by heads, fc1 and fc2, the head; their proj, which the
rules do not name, stays whole and takes the heads' outputs gathered.
Their row-parallel fc2 sums float32 partial products over the group
(``ModelAxis.reduce``), so their logits differ from the single-process
step's by that order of summation.

**Sequence parallelism** (``seq_parallel=True``, QAT ViT only): between
the blocks' matmuls each rank holds a ceil-sized block of the token axis
(197 tokens over 2 ranks: 99 and 98), so the LayerNorms, the
requantizations and the 16-bit residual ``QuantAct``s run on 1/n of the
tokens. A column layer gathers the tokens and a row layer keeps its
tokens of the sum; the LayerNorms' gradients are then summed over the
group. An attention or Mlp the axis leaves whole (3 heads at 2, DeiT-S's
6 at 4) gathers every rank's tokens before it, runs whole on every rank
and keeps this rank's block after it (``nn.vit_blocks.whole_tokens`` and
``own_tokens``), as the trunk's entry and exit do: the block's backward
gathers the gradient of its output whole on every rank, so each rank
forms the layer's whole gradient and its parameters stay out of
``partial``. Every op between the matmuls is per token, so the values
equal the plain tensor-parallel step's bit for bit.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..nn.quant import LinearSplit
from .data import slot_lists
from .mesh import Mesh, ModelAxis, param_shardings, split_positions, splits, tp_groups


def param_slices(model: nn.Module, mesh: Mesh) -> dict:
    """Each split parameter of the whole ``model`` (``param_shardings``)
    by torch name: ``(dim, [positions of rank 0, 1, ...])`` along its
    split dimension (``split_positions``: ``qkv`` by heads); replicated
    parameters are absent."""
    n = mesh.shape["model"]
    heads = {g[3][0]: g[2] for g in tp_groups(model) if g[0] == "attn"}
    out = {}
    for (name, p), spec in zip(model.named_parameters(), param_shardings(model, mesh).values()):
        if "model" in spec:
            d = spec.index("model")
            h = heads.get(name.rsplit(".", 1)[0])  # None but for qkv
            out[name] = (d, [torch.from_numpy(split_positions(p.shape[d], n, r, h)) for r in range(n)])
    return out


@dataclasses.dataclass
class TensorParallel:
    """A tensor-parallel model's layout (``model.tp``): the mesh, the
    model axis, each split parameter's ``param_slices`` entry, and the
    names of the replicated parameters whose gradient each rank forms
    only in part (summed over the model group by ``reduce_grads``)."""

    mesh: Mesh
    axis: ModelAxis
    slices: dict
    partial: frozenset

    @property
    def seq_axis(self) -> ModelAxis | None:
        """The axis under sequence parallelism, else None."""
        return self.axis if self.axis.tokens is not None else None

    def take(self, t: torch.Tensor, name: str) -> torch.Tensor:
        """This rank's slice of parameter ``name``'s whole-shaped ``t``."""
        if name not in self.slices:
            return t
        d, pos = self.slices[name]
        return t.index_select(d, pos[self.axis.rank].to(t.device)).contiguous()

    def join(self, t: torch.Tensor, name: str) -> torch.Tensor:
        """Parameter ``name``'s whole tensor from every rank's slice ``t``."""
        if name not in self.slices:
            return t
        d, pos = self.slices[name]
        parts = self.mesh.all_gather(t.contiguous(), "model", d)
        return torch.empty_like(parts).index_copy_(d, torch.cat(pos).to(t.device), parts)

    @torch.no_grad()
    def reduce_grads(self, grads: list, names: list) -> list:
        """``grads`` with each ``partial`` leaf summed over the model group
        (one all-reduce of their float32 concatenation)."""
        at = [i for i, n in enumerate(names) if n in self.partial]
        if not at:
            return grads
        flat = self.axis.sum(torch.cat([grads[i].reshape(-1) for i in at]))
        out, k = list(grads), 0
        for i in at:
            out[i] = flat[k:k + grads[i].numel()].view(grads[i].shape)
            k += grads[i].numel()
        return out

    @torch.no_grad()
    def global_norm(self, grads: list, names: list) -> torch.Tensor:
        """‖g‖ over the whole model: each split leaf's squares summed over
        the model group, each replicated leaf's counted once."""
        sq = torch.stack(torch._foreach_norm(grads)) ** 2
        split = torch.tensor([n in self.slices for n in names], device=sq.device)
        return torch.sqrt(self.axis.sum(sq[split].sum()) + sq[~split].sum())


def tensor_parallel(state, mesh: Mesh, seq_parallel: bool = False):
    """Make ``state`` (a whole ``train.TrainState`` of a QAT or float ViT
    or Swin) this rank's share of a tensor-parallel state on ``mesh``'s
    model axis, in place: the split layers' parameters, optimizer moments
    and EMA cut to the rank's slices, every split layer wired to the
    axis, ``state.model.tp`` set. Every rank calls it on the same whole
    state; ``parallel.shard_train_state`` may then add ZeRO-1 on the data
    axis. ``seq_parallel`` adds sequence parallelism (the QAT ViT only:
    ``ValueError`` for another model). Returns ``state``."""
    from ..models.swin import SwinTransformer
    from ..models.swin_float import FloatSwinTransformer
    from ..models.vit import VisionTransformer
    from ..models.vit_float import FloatVisionTransformer

    model = state.model
    if not isinstance(model, (VisionTransformer, SwinTransformer, FloatVisionTransformer, FloatSwinTransformer)):
        raise TypeError(f"tensor parallelism takes a QAT or float VisionTransformer or SwinTransformer, not "
                        f"{type(model).__name__}")
    if model.tp is not None:
        raise ValueError("the model is tensor-parallel already")
    n, m = mesh.shape["model"], mesh.coords["model"]
    groups = tp_groups(model)
    if seq_parallel:
        if not isinstance(model, VisionTransformer):
            raise ValueError("sequence parallelism runs on the QAT ViT family only (JAX's seq_constraint has no "
                             "Swin or float form)")
    axis = ModelAxis(mesh, model.pos_embed.shape[1] if seq_parallel else None)
    names = [name for name, _ in model.named_parameters()]
    slices = param_slices(model, mesh)
    flat = hasattr(model, "attn_heads")  # a float model: its layers by flax's flat names
    partial = set()
    for kind, path, count, layers in groups:
        if not splits(count, n):
            if seq_parallel and kind != "head":  # whole on every rank: all the tokens in, this rank's out
                model.get_submodule(path).seq = axis
            continue
        local = count // n
        if kind == "attn":
            model.get_submodule(layers[0]).split = LinearSplit(axis, rows=False, seq=seq_parallel)
            if flat:  # its proj stays whole (tp_groups)
                table = f"{path}_relative_position_bias_table"
            else:
                mod = model.get_submodule(path)
                mod.heads = (m * local, (m + 1) * local)
                mod.proj.split = LinearSplit(axis, rows=True, seq=seq_parallel)
                table = f"{path}.relative_position_bias_table"
            if table in names:  # quantized (QAT) whole, then cut by heads: every rank forms a part of its gradient
                partial.add(table)
        elif kind == "mlp":
            fc1, fc2 = (model.get_submodule(name) for name in layers)
            fc1.split = LinearSplit(axis, rows=False, seq=seq_parallel)
            fc2.split = LinearSplit(axis, rows=True, seq=seq_parallel)
            if not flat:
                mod = model.get_submodule(path)
                mod.hidden = (m * local, (m + 1) * local)
                if not mod.act.stable:
                    mod.act.row_max = axis.row_max
        else:
            model.head.split = LinearSplit(axis, rows=False)
    if seq_parallel:  # the blocks' LayerNorms see this rank's tokens
        partial.update(name for name in names if ".norm1." in name or ".norm2." in name)
    tp = TensorParallel(mesh, axis, slices, frozenset(partial))
    with torch.no_grad():
        for name in slices:
            path, leaf = name.rsplit(".", 1)
            mod = model.get_submodule(path)
            mod._parameters[leaf] = nn.Parameter(tp.take(mod._parameters[leaf].detach(), name))
        for slot in slot_lists(state.opt_state):
            setattr(state.opt_state, slot, [tp.take(t, nm) for t, nm in zip(getattr(state.opt_state, slot), names)])
        if state.ema_params is not None:
            state.ema_params = {nm: tp.take(t, nm) for nm, t in state.ema_params.items()}
    model.tp = tp
    return state
