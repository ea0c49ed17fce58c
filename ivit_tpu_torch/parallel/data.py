"""Data-parallel QAT: the collectives of the train and eval steps, and
ZeRO-1 for the port's optimizers.

What GSPMD does implicitly for the JAX trainer over a data-sharded batch,
the port does explicitly (``train.steps`` with a ``mesh``):

* every ``QuantAct`` range is the global batch's (``batch_shard``: one
  all-reduce MAX of (−min, max) over the data group per update, inside
  ``nn.quant.data_shard``), and the dropout and drop-path masks are drawn
  for the global batch from the step's generator, the same on every
  rank, each rank keeping its rows; so every range and every logit equals
  the single-process step's on the global batch, bit for bit;
* the gradients are averaged over equal shards (``data_mean``); the
  global-norm clip then runs on the averaged gradient, and the loss and
  accuracy reported are the global ones. The average sums the shards'
  float32 gradients in another order than one backward over the global
  batch does, so the parameters agree with the single-process step's to
  within that rounding, not bit for bit.

**ZeRO-1** (``shard_train_state``, the counterpart of JAX's
``zero1_shardings`` with its default ``include_ema``): each rank keeps
only its slice of every optimizer moment and of the EMA, along the dimension
``parallel.mesh.zero1_shardings`` picks; a leaf nothing divides stays
whole on every rank. A step updates the rank's slices of the parameters
from the averaged gradient with the optimizer's own ``_foreach``
arithmetic, blends its EMA slices, and all-gathers the parameters: the
same elementwise math on the same gradient as the replicated step, so
the two agree bit for bit. ``gather_train_state`` rebuilds the whole
state (optax's layout in a checkpoint) for rank 0 to write.
"""

from __future__ import annotations

import dataclasses

import torch

from ..nn.quant import DataShard
from .mesh import Mesh, zero1_shardings


def batch_shard(mesh: Mesh) -> DataShard:
    """This rank's ``nn.quant.DataShard`` of a batch split over the
    mesh's ``data`` axis: its ranges reduced by MIN/MAX over every rank
    of the mesh, which covers the data group's rows and, on a model axis
    (``parallel.tensor``), the heads, columns or tokens each rank holds
    (a rank holding the whole tensor repeats a value, which MIN/MAX
    takes without harm)."""

    def reduce_range(lo: torch.Tensor, hi: torch.Tensor):
        both = mesh.all_reduce(torch.stack([-lo, hi]), "world", op="max")
        return -both[0], both[1]

    return DataShard(mesh.coords["data"], mesh.shape["data"], reduce_range)


def data_mean(tensors: list, mesh: Mesh) -> list:
    """The mean over the data group of each tensor (one all-reduce of
    their float32 concatenation)."""
    n = mesh.shape["data"]
    if mesh.groups.get("data") is None:
        return list(tensors)
    flat = torch.cat([t.reshape(-1).to(torch.float32) for t in tensors])
    flat = torch.div(mesh.all_reduce(flat, "data"), n)
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].view(t.shape).to(t.dtype))
        at += t.numel()
    return out


@dataclasses.dataclass
class Zero1:
    """A train state's ZeRO-1 layout: for each parameter (in
    ``named_parameters`` order) the dimension this rank slices, or None
    for a leaf kept whole, and the mesh."""

    mesh: Mesh
    dims: list

    def take(self, t: torch.Tensor, i: int) -> torch.Tensor:
        """This rank's slice of parameter ``i``'s full-shaped ``t``."""
        d = self.dims[i]
        return t if d is None else self.mesh.block(t, "data", d)

    def join(self, t: torch.Tensor, i: int) -> torch.Tensor:
        """Parameter ``i``'s full-shaped tensor from every rank's slice."""
        d = self.dims[i]
        return t if d is None else self.mesh.all_gather(t, "data", d)


def slot_lists(opt_state) -> list:
    """The names of the optimizer state's per-parameter lists (AdamW's
    ``mu`` and ``nu``, SGD's ``trace``)."""
    return [f.name for f in dataclasses.fields(opt_state) if isinstance(getattr(opt_state, f.name), list)]


def shard_train_state(state, mesh: Mesh):
    """Slice ``state``'s optimizer moments and its EMA to this rank's
    ZeRO-1 share, in place; returns it. Every rank calls it on the same
    full state."""
    specs = zero1_shardings(state.model, mesh)
    names = [n for n, _ in state.model.named_parameters()]
    layout = Zero1(mesh, [specs[n].index("data") if "data" in specs[n] else None for n in names])
    for slot in slot_lists(state.opt_state):
        full = getattr(state.opt_state, slot)
        setattr(state.opt_state, slot, [layout.take(t, i).clone() for i, t in enumerate(full)])
    if state.ema_params is not None:
        state.ema_params = {n: layout.take(state.ema_params[n], i).clone() for i, n in enumerate(names)}
    state.zero1 = layout
    return state


class GatheredModel:
    """A tensor-parallel model's whole variables, as a checkpoint reads a
    model: ``named_parameters`` and ``named_buffers`` in the
    single-process model's names, order and shapes."""

    def __init__(self, params: dict, buffers: dict):
        self._params, self._buffers = params, buffers

    def named_parameters(self):
        return iter(self._params.items())

    def named_buffers(self):
        return iter(self._buffers.items())


def gather_train_state(state):
    """A whole copy of a ZeRO-1, tensor-parallel or pipelined ``state``,
    in the single-process layout a checkpoint holds: the moments and the
    EMA gathered over the data axis, then every split leaf (the
    parameters too) over the model axis, or every stage's blocks over the
    pipe axis (``parallel.pipeline.from_pp_state``), where the model
    becomes a ``GatheredModel`` of the whole variables. Every rank calls
    it; a state with none of them comes back as it is."""
    pp = getattr(state.model, "pp", None)
    if pp is not None:
        return pp.gather(state)
    layout, tp = state.zero1, getattr(state.model, "tp", None)
    if layout is None and tp is None:
        return state
    names = [n for n, _ in state.model.named_parameters()]

    def whole(t, i):
        t = t if layout is None else layout.join(t, i)
        return t if tp is None else tp.join(t, names[i])

    opt = dataclasses.replace(state.opt_state, **{
        slot: [whole(t, i) for i, t in enumerate(getattr(state.opt_state, slot))]
        for slot in slot_lists(state.opt_state)})
    ema = state.ema_params
    if ema is not None:
        ema = {n: whole(ema[n], i) for i, n in enumerate(names)}
    model = state.model
    if tp is not None:
        model = GatheredModel({n: tp.join(p.detach(), n) for n, p in model.named_parameters()},
                              {n: b.detach().clone() for n, b in model.named_buffers()})
    return dataclasses.replace(state, model=model, opt_state=opt, ema_params=ema, zero1=None)


@torch.no_grad()
def zero1_update(state, params: list, grads: list, ema_decay: float) -> None:
    """One optimizer update and EMA blend of a ZeRO-1 ``state`` on the
    averaged ``grads``: each rank updates its slices of the parameters
    and of the EMA, then the parameters are all-gathered in place."""
    layout = state.zero1
    mine = [layout.take(p, i).clone() for i, p in enumerate(params)]
    state.tx.update(mine, [layout.take(g, i).contiguous() for i, g in enumerate(grads)], state.opt_state)
    for i, p in enumerate(params):
        p.copy_(layout.join(mine[i], i))
    if state.ema_params is not None:
        ema = [state.ema_params[n] for n, _ in state.model.named_parameters()]
        torch._foreach_mul_(ema, ema_decay)
        torch._foreach_add_(ema, torch._foreach_mul(mine, 1.0 - ema_decay))
