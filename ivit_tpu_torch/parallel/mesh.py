"""Process groups, the ``(data, model)`` mesh, data-parallel serving and
the ZeRO-1 layout of the optimizer state.

Counterpart of ``ivit_tpu/parallel/mesh.py``. JAX lays a mesh over the
devices of one program and lets GSPMD insert the collectives; here every
rank is a process (``torchrun``, or ``torch.multiprocessing`` in the
tests) and the port calls the collectives itself:

* ``init_distributed`` joins the process group, the counterpart of
  ``jax.distributed.initialize()``;
* ``make_mesh`` lays the ranks out row-major as
  ``np.asarray(devices).reshape(data, model)`` does: at ``(2, 2)`` the
  model groups are ranks {0, 1} and {2, 3}, the data groups {0, 2} and
  {1, 3}; ``grid_mesh`` under it also lays ``parallel.pipeline``'s
  ``(data, pipe)`` mesh, whose stages talk by point-to-point messages
  (``Mesh.isend``, ``recv``, ``broadcast``). Its device is this rank's
  card unless the caller names the CPU: without a card it raises;
* ``shard_infer`` is data-parallel serving: each data rank runs the
  unchanged engine on its rows of the global batch and the logits are
  all-gathered, so they equal the single-process engine's bit for bit;
* ``zero1_shardings`` says along which dimension each rank holds its
  slice of the optimizer moments and of the EMA (``_add_axis``: the
  largest evenly divisible one); ``parallel.data`` runs the step on it;
* ``ModelAxis`` holds the model group's collectives as a tensor-parallel
  model's layers call them (``parallel.tensor``), as
  ``torch.autograd.Function``s where a gradient crosses them: the
  identity whose gradient is summed, the sum whose gradient is the
  identity, the token gather and scatter of sequence parallelism
  (ceil-sized blocks, ``Mesh.bounds``), the last-dimension gather, the
  row max.

**Backends and devices.** ``nccl`` when every rank has a card of its
own (rank r runs on ``cuda:LOCAL_RANK``), ``gloo`` on the CPU. Several
ranks share one card only over ``gloo`` and only when the caller names
it: ``gloo`` has no collectives on CUDA tensors, so the mesh stages each
collective's tensor through the host while the engines and kernels stay
on the card. ``nccl`` asked for with more ranks on a host than cards
raises; no backend or device is swapped silently.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

# (path-substring, spec) — first match wins; ``ivit_tpu/parallel/mesh.py``'s
# rules over flax paths ("/"-joined). Kernels are stored (in, out):
# column-parallel layers shard the out axis, row-parallel layers the in axis.
_PARAM_RULES = (
    ("qkv/kernel", (None, "model")),
    ("qkv/bias", ("model",)),
    ("attn/proj/kernel", ("model", None)),
    ("fc1/kernel", (None, "model")),
    ("fc1/bias", ("model",)),
    ("fc2/kernel", ("model", None)),
    ("head/kernel", (None, "model")),
    ("head/bias", ("model",)),
)

# torchrun's environment, which init_distributed reads without an init_method
TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


@dataclasses.dataclass(frozen=True)
class Distributed:
    """What ``init_distributed`` joined: this process's rank, the world,
    its rank on its host, its device and the default group's backend."""

    rank: int
    world_size: int
    local_rank: int
    device: torch.device
    backend: str


def _rank_device(device, backend: str | None, local_rank: int, local_world: int) -> tuple[torch.device, str]:
    """The device and backend of a rank: the CPU over ``gloo``; a card
    over ``nccl`` (the default on CUDA) when each of the host's
    ``local_world`` ranks has one, rank r on ``cuda:r``; ranks sharing
    cards only over a ``gloo`` the caller named. Raises where these
    cannot hold."""
    kind = torch.device(device).type
    if kind == "cpu":
        if backend not in (None, "gloo"):
            raise ValueError(f"backend {backend!r} on the CPU: the CPU's backend is gloo")
        return torch.device("cpu"), "gloo"
    if kind != "cuda":
        raise ValueError(f"device {device!r}: cuda or cpu")
    cards = torch.cuda.device_count()
    if cards == 0:
        raise RuntimeError("no CUDA device: pass device='cpu' (gloo) to run the ranks on the CPU")
    backend = backend or "nccl"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: nccl or gloo")
    if backend == "nccl" and local_world > cards:
        raise RuntimeError(f"nccl: {local_world} ranks on this host outnumber its {cards} CUDA device(s); "
                           "nccl needs a card for each rank (name backend='gloo' to share the cards)")
    return torch.device("cuda", local_rank % cards), backend


def init_distributed(backend: str | None = None, device="cuda", init_method: str | None = None,
                     rank: int | None = None, world_size: int | None = None,
                     local_rank: int | None = None) -> Distributed:
    """Join the default process group, the counterpart of
    ``jax.distributed.initialize()``. Without ``init_method`` it reads
    torchrun's environment (``TORCHRUN_ENV``) and raises ``RuntimeError``
    naming what is missing; with one (``file://...`` in the tests) the
    caller gives ``rank`` and ``world_size``. The backend and device
    follow ``_rank_device``; CUDA ranks are bound to their card."""
    if init_method is None:
        missing = [k for k in TORCHRUN_ENV if k not in os.environ]
        if missing:
            raise RuntimeError(f"torch.distributed: no torchrun environment ({', '.join(missing)} unset); launch "
                               "with `python -m torch.distributed.run --nproc-per-node N -m ...`")
        rank, world_size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        local_rank = int(os.environ["LOCAL_RANK"])
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
        init_method = "env://"
    else:
        if rank is None or world_size is None:
            raise ValueError("init_distributed: an init_method needs rank and world_size")
        local_rank = rank if local_rank is None else local_rank
        local_world = world_size
    dev, backend = _rank_device(device, backend, local_rank, local_world)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world_size)
    return Distributed(rank, world_size, local_rank, dev, backend)


class Mesh:
    """A ``(data, model)`` grid of ranks, or a ``(data, pipe)`` one
    (``axis``: the second axis' name; ``parallel.pipeline``), with a
    process group per row and column. ``shape`` and ``coords`` are dicts
    by axis name; ``rank`` is this rank's position in the grid, ``ranks``
    the world rank at each position; ``device`` is this rank's device.
    The collectives take an axis name (``"data"``, the second axis, or
    ``"world"`` for every rank of the grid); on an axis of one rank
    without a process group they return their input."""

    def __init__(self, data: int, model: int, rank: int, device, groups: dict, axis: str = "model",
                 ranks=None):
        self.axis = axis
        self.shape = {"data": data, axis: model}
        self.rank = rank
        self.coords = {"data": rank // model, axis: rank % model}
        self.device = torch.device(device)
        self.groups = groups
        self.ranks = list(range(data * model)) if ranks is None else [int(r) for r in ranks]

    def __repr__(self) -> str:
        return (f"Mesh(data={self.shape['data']}, {self.axis}={self.shape[self.axis]}, rank={self.rank}, "
                f"device={self.device})")

    @staticmethod
    def _staging(group, device) -> torch.device:
        """Where the group's backend takes a tensor of ``device``: the
        host for ``gloo`` and a CUDA tensor, else ``device`` itself."""
        device = torch.device(device)
        if device.type == "cuda" and dist.get_backend(group) == "gloo":
            return torch.device("cpu")
        return device

    def _staged(self, t: torch.Tensor, group) -> torch.Tensor:
        """A copy of ``t`` where the group's backend can take it
        (``_staging``)."""
        return t.detach().to(self._staging(group, t.device), copy=True)

    def peer(self, axis: str, offset: int) -> int:
        """The world rank ``offset`` positions from this one along ``axis``."""
        n, i = self.shape[axis], self.coords[axis]
        if not 0 <= i + offset < n:
            raise ValueError(f"no rank {offset:+d} from coordinate {i} of the {axis} axis of {n} ranks")
        step = 1 if axis == self.axis else self.shape[self.axis]
        return self.ranks[self.rank + offset * step]

    def isend(self, t: torch.Tensor, axis: str, offset: int, tag: int):
        """Start sending ``t`` to the rank ``offset`` along ``axis`` (a
        point-to-point message on that axis' group, ``tag`` telling it
        from the others in flight); returns the pending work, whose
        ``wait()`` the caller owes before the group is destroyed (it
        holds the host copy a ``gloo`` group sends from)."""
        group = self.groups[axis]
        return dist.isend(self._staged(t, group).contiguous(), self.peer(axis, offset), group=group, tag=tag)

    def recv(self, shape, axis: str, offset: int, tag: int, dtype=torch.float32) -> torch.Tensor:
        """The tensor of ``shape`` the rank ``offset`` along ``axis`` sent
        with ``tag`` (``isend``), on this rank's device."""
        group = self.groups[axis]
        buf = torch.empty(shape, dtype=dtype, device=self._staging(group, self.device))
        dist.recv(buf, self.peer(axis, offset), group=group, tag=tag)
        return buf.to(self.device)

    def broadcast(self, t: torch.Tensor | None, axis: str, src: int, shape=None, dtype=torch.float32) -> torch.Tensor:
        """The tensor of the rank at coordinate ``src`` of ``axis``, on
        every rank of its group: that rank passes it, the others pass None
        and its ``shape``."""
        group = self.groups.get(axis)
        if group is None:
            return t
        if self.coords[axis] == src:
            buf = self._staged(t, group).contiguous()
        else:
            buf = torch.empty(shape, dtype=dtype, device=self._staging(group, self.device))
        step = 1 if axis == self.axis else self.shape[self.axis]
        dist.broadcast(buf, self.ranks[self.rank + (src - self.coords[axis]) * step], group=group)
        return buf.to(self.device)

    def all_reduce(self, t: torch.Tensor, axis: str, op: str = "sum") -> torch.Tensor:
        """``t`` reduced over ``axis``'s group (``op``: sum, min or max)."""
        group = self.groups.get(axis)
        if group is None:
            return t
        buf = self._staged(t, group)
        dist.all_reduce(buf, op=getattr(dist.ReduceOp, op.upper()), group=group)
        return buf.to(t.device)

    def all_gather(self, t: torch.Tensor, axis: str, dim: int = 0, size: int | None = None) -> torch.Tensor:
        """The group's ``t`` concatenated along ``dim`` in the order of
        their coordinate on ``axis``: equal shapes, or with ``size`` the
        ceil-sized blocks of a ``size``-long dimension (``block(...,
        even=False)``), each padded to the block before the gather and the
        padding, all at the end, stripped after."""
        group = self.groups.get(axis)
        if group is None:
            return t
        buf = self._staged(t, group).contiguous()
        if size is not None:
            b = -(-size // self.shape[axis])
            if buf.shape[dim] < b:
                pad = list(buf.shape)
                pad[dim] = b - buf.shape[dim]
                buf = torch.cat([buf, buf.new_zeros(pad)], dim)
        parts = [torch.empty_like(buf) for _ in range(self.shape[axis])]
        dist.all_gather(parts, buf, group=group)
        out = torch.cat(parts, dim)
        if size is not None:
            out = out.narrow(dim, 0, size)
        return out.to(t.device)

    def bounds(self, size: int, axis: str, even: bool = True) -> tuple[int, int]:
        """``[start, stop)`` of this rank's block of ``size`` entries split
        over ``axis``: equal blocks (``ValueError`` where ``size`` does not
        divide), or with ``even=False`` ceil-sized blocks, the last ones
        shorter (197 tokens over 2 ranks: 99 and 98; 17 over 4: 5, 5, 5
        and 2), ``ValueError`` where a rank would hold none."""
        n, i = self.shape[axis], self.coords[axis]
        if even:
            if size % n:
                raise ValueError(f"{size} is not divisible by the {axis} axis of {n} ranks")
            b = size // n
        else:
            b = -(-size // n)
            if (n - 1) * b >= size:
                raise ValueError(f"{size} entries in ceil-sized blocks of {b} leave a rank of the {axis} axis of "
                                 f"{n} ranks none")
        return min(i * b, size), min((i + 1) * b, size)

    def block(self, x, axis: str, dim: int = 0, even: bool = True):
        """This rank's block of ``x`` (a tensor or an array) along ``dim``,
        split over ``axis`` as ``bounds`` says."""
        start, stop = self.bounds(x.shape[dim], axis, even)
        index = [slice(None)] * x.ndim
        index[dim] = slice(start, stop)
        return x[tuple(index)]


def grid_mesh(data: int | None, second: int, axis: str, backend: str | None = None, device=None,
              ranks=None) -> Mesh | None:
    """A ``(data, axis)`` grid over ``ranks`` (the default group's world
    when None), laid out row-major: position = data index · second + index
    on ``axis``. Every rank of the world calls it, with the same
    arguments: it creates a group for each row (``axis``), each column
    (data) and one of all the grid's ranks (world), on ``backend`` (the
    default group's when None); a rank outside ``ranks`` gets None. The
    port's entry points lay their grid over the whole world; ``ranks``
    lets one spawn of test ranks hold several grids side by side (each
    subset of the world its own mesh) instead of a spawn for each.
    Without a process group it is a grid of one, whose collectives
    return their input. ``device`` is the grid's device: when None, the
    card this process was bound to (``init_distributed`` binds a CUDA
    rank); without CUDA the caller must name ``"cpu"`` (``RuntimeError``).
    """
    if dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
    else:
        world, rank = 1, 0
    members = list(range(world)) if ranks is None else [int(r) for r in ranks]
    if data is None:
        data = len(members) // second
    if data * second != len(members):
        where = f"WORLD_SIZE {world} ranks" if ranks is None else f"the {len(members)} ranks {members}"
        raise ValueError(f"mesh {data}x{second} != {where}")
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device; pass device='cpu' to lay the mesh on the CPU")
        device = torch.device("cuda", torch.cuda.current_device())
    groups: dict = {}
    grid = np.asarray(members).reshape(data, second)
    if dist.is_initialized():
        backend = backend or dist.get_backend()
        for name, lines in ((axis, grid), ("data", grid.T), ("world", grid.reshape(1, -1))):
            for line in lines:
                g = dist.new_group([int(r) for r in line], backend=backend)
                if rank in line:
                    groups[name] = g
    if rank not in members:
        return None
    return Mesh(data, second, members.index(rank), device, groups, axis=axis, ranks=members)


def make_mesh(data: int | None = None, model: int = 1, backend: str | None = None, device=None) -> Mesh:
    """A ``(data, model)`` mesh over the ranks of the default process
    group (``grid_mesh``; ``data`` defaults to world / model), laid out
    row-major as ``np.asarray(devices).reshape(data, model)`` lays JAX's:
    rank = data index · model + model index. ``device`` defaults to this
    rank's card and raises without one unless the caller names
    ``"cpu"``."""
    return grid_mesh(data, model, "model", backend, device)


class _Copy(torch.autograd.Function):
    """Forward the identity, backward the sum over the model group: the
    input of a column-parallel layer, whose gradient each rank forms from
    its own columns (Megatron's f)."""

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g.contiguous(), "model"), None


class _Reduce(torch.autograd.Function):
    """Forward the sum over the model group, backward the identity: the
    output of a row-parallel float layer, each rank's partial product of
    its input rows (Megatron's g)."""

    @staticmethod
    def forward(ctx, t, mesh):
        return mesh.all_reduce(t.contiguous(), "model")

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherLast(torch.autograd.Function):
    """Forward the model group's equal blocks concatenated along the last
    dimension, backward this rank's block of the gradient."""

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return mesh.all_gather(t, "model", t.dim() - 1)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.block(g, "model", g.dim() - 1).contiguous(), None


class _GatherTokens(torch.autograd.Function):
    """Forward the model group's token blocks (dimension 1, ceil-sized)
    concatenated to all ``size`` tokens, backward this rank's tokens of
    the gradient: summed over the group first (a reduce-scatter) where
    each rank's consumer forms a part of it (a column-parallel layer),
    as it is where every rank forms all of it (a replicated one)."""

    @staticmethod
    def forward(ctx, t, mesh, size, grad_sum):
        ctx.mesh, ctx.grad_sum = mesh, grad_sum
        return mesh.all_gather(t, "model", 1, size)

    @staticmethod
    def backward(ctx, g):
        if ctx.grad_sum:
            g = ctx.mesh.all_reduce(g.contiguous(), "model")
        return ctx.mesh.block(g, "model", 1, even=False).contiguous(), None, None, None


class _ScatterTokens(torch.autograd.Function):
    """Forward this rank's token block of a tensor every rank holds whole,
    backward the group's gradient blocks gathered (_GatherTokens the
    other way round)."""

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh, ctx.size = mesh, t.shape[1]
        return mesh.block(t, "model", 1, even=False).clone()

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_gather(g.contiguous(), "model", 1, ctx.size), None


class _RowMax(torch.autograd.Function):
    """The max over the last dimension of a tensor whose columns the model
    group splits (keepdim): the local max, then a MAX over the group.
    Backward as ``torch.amax``'s over the whole row: the gradient, summed
    over the group (each rank's columns add their share), split evenly
    among the entries equal to the max, wherever they lie."""

    @staticmethod
    def forward(ctx, q, mesh):
        m = mesh.all_reduce(torch.amax(q, -1, keepdim=True), "model", op="max")
        if ctx.needs_input_grad[0]:
            hit = q == m
            ctx.save_for_backward(hit, mesh.all_reduce(hit.sum(-1, keepdim=True).to(q.dtype), "model"))
        ctx.mesh = mesh
        return m

    @staticmethod
    def backward(ctx, g):
        hit, count = ctx.saved_tensors
        g = ctx.mesh.all_reduce(g.contiguous(), "model")
        return (g / count) * hit, None


class ModelAxis:
    """The model axis of a tensor-parallel QAT model
    (``parallel.tensor``): the model group's collectives as the layers
    call them, differentiable where a gradient crosses them. Every one
    goes through ``Mesh``, so a ``gloo`` group on the card stages it
    through the host. ``tokens`` is the token count of a sequence-parallel
    model (None without sequence parallelism): between its blocks'
    matmuls each rank holds the ceil-sized block ``mesh.bounds(tokens,
    "model", even=False)`` of the token axis (dimension 1)."""

    def __init__(self, mesh: Mesh, tokens: int | None = None):
        self.mesh, self.tokens = mesh, tokens
        self.size, self.rank = mesh.shape["model"], mesh.coords["model"]

    def copy(self, t: torch.Tensor) -> torch.Tensor:
        """``t``; its gradient summed over the group (``_Copy``)."""
        return _Copy.apply(t, self.mesh)

    def reduce(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the group; its gradient passed as it is
        (``_Reduce``)."""
        return _Reduce.apply(t, self.mesh)

    def gather_last(self, t: torch.Tensor) -> torch.Tensor:
        """The group's equal blocks of the last dimension concatenated."""
        return _GatherLast.apply(t, self.mesh)

    def gather_tokens(self, t: torch.Tensor, grad_sum: bool = True) -> torch.Tensor:
        """All ``tokens`` tokens from each rank's block (``_GatherTokens``);
        ``grad_sum=False`` where every rank forms the whole gradient."""
        return _GatherTokens.apply(t, self.mesh, self.tokens, grad_sum)

    def scatter_tokens(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's token block of a tensor every rank holds whole."""
        return _ScatterTokens.apply(t, self.mesh)

    def token_bounds(self) -> tuple[int, int]:
        """``[start, stop)`` of this rank's tokens."""
        return self.mesh.bounds(self.tokens, "model", even=False)

    def row_max(self, q: torch.Tensor) -> torch.Tensor:
        """The max over the whole split row (``_RowMax``)."""
        return _RowMax.apply(q, self.mesh)

    def max(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` reduced by MAX over the group; no gradient."""
        return self.mesh.all_reduce(t.detach(), "model", op="max")

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the group; no gradient (an exact dot's int32
        partial products)."""
        return self.mesh.all_reduce(t, "model")

    def sum_tokens(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the group, then this rank's tokens (a
        reduce-scatter); no gradient."""
        return self.mesh.block(self.mesh.all_reduce(t, "model"), "model", 1, even=False).contiguous()

    def all_tokens(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's token block gathered; no gradient."""
        return self.mesh.all_gather(t, "model", 1, self.tokens)


def shard_infer(infer_fn, mesh: Mesh):
    """Data-parallel serving: ``images (global batch) → logits``. Each
    data rank runs ``infer_fn`` (an engine of ``deploy``) unchanged on
    its rows and the logits are all-gathered over ``data``; per-example
    integer compute is untouched, so they equal the single-process
    engine's bit for bit. Every rank of the mesh calls it with the same
    global batch, which must be divisible by ``mesh.shape['data']``
    (``ValueError``)."""

    def sharded(images: torch.Tensor) -> torch.Tensor:
        return mesh.all_gather(infer_fn(mesh.block(images, "data")), "data")

    for attr in ("kernels", "device"):
        if hasattr(infer_fn, attr):
            setattr(sharded, attr, getattr(infer_fn, attr))
    return sharded


def _spec_for(path: str, ndim: int, model_size: int) -> tuple:
    if model_size > 1:
        for frag, spec in _PARAM_RULES:
            if frag in path and len(spec) <= ndim:
                return spec + (None,) * (ndim - len(spec))
    return (None,) * ndim


def _add_axis(shape: tuple, base: tuple, n: int, axis: str) -> tuple:
    """``base`` with ``axis`` on the largest still-free dimension of
    ``shape`` that ``n`` divides evenly (``base`` unchanged where none
    does: scalars, small vectors), as JAX's ``_add_axis``."""
    spec = list(base) + [None] * (len(shape) - len(base))
    dims = [i for i in range(len(shape)) if spec[i] is None and shape[i] >= n and shape[i] % n == 0]
    if not dims:
        return tuple(base)
    spec[max(dims, key=lambda i: shape[i])] = axis
    return tuple(spec)


def splits(count: int, n: int) -> bool:
    """Whether a model axis of ``n`` ranks splits a layer of ``count``
    heads (an attention: qkv, proj), hidden columns (an Mlp: fc1, fc2) or
    classes (the head). One that it does not divide stays whole on every
    rank, in training (``whole_layers``) as in serving
    (``parallel.tp_infer``): DeiT-S's 6 heads at 4, Swin-T's 3 stage-1
    heads at 2."""
    return count % n == 0


def split_positions(size: int, n: int, r: int, heads: int | None = None) -> np.ndarray:
    """Rank ``r`` of ``n``'s positions along a split dimension ``size``
    long: a contiguous block, or for ``qkv`` (``heads`` given) the q, k
    and v columns of the rank's heads, in the (3, H, hd) order the
    attention reads them."""
    if heads is None:
        b = size // n
        return np.arange(r * b, (r + 1) * b)
    C = size // 3
    hd, hl = C // heads, heads // n
    return (np.arange(3)[:, None, None] * C + (r * hl + np.arange(hl))[None, :, None] * hd
            + np.arange(hd)[None, None, :]).reshape(-1)


def tp_groups(model: torch.nn.Module) -> list:
    """The layers a model axis may split, as ``(kind, path, count,
    layers)``: ``"attn"`` (``count`` its heads; ``layers`` its qkv and
    proj), ``"mlp"`` (its hidden width; fc1 and fc2) or ``"head"`` (the
    classes), each layer by module name. The QAT models' attentions are
    the modules with ``qkv`` and ``num_heads``, their Mlps those with
    ``hidden_features``; a float model (flax's flat names) lists its
    qkv layers' heads in ``attn_heads``, and JAX's rules, which name
    ``attn/proj``, leave its proj whole."""
    out = []
    for path, mod in model.named_modules():
        if hasattr(mod, "qkv") and hasattr(mod, "num_heads"):
            out.append(("attn", path, mod.num_heads, (f"{path}.qkv", f"{path}.proj")))
        elif hasattr(mod, "hidden_features"):
            out.append(("mlp", path, mod.hidden_features, (f"{path}.fc1", f"{path}.fc2")))
    for qkv, heads in getattr(model, "attn_heads", {}).items():
        pre = qkv[:-len("_attn_qkv")]
        fc1, fc2 = f"{pre}_mlp_fc1", f"{pre}_mlp_fc2"
        out.append(("attn", f"{pre}_attn", heads, (qkv,)))
        out.append(("mlp", f"{pre}_mlp", model.get_submodule(fc1).kernel.shape[1], (fc1, fc2)))
    out.append(("head", "head", model.head.kernel.shape[1], ("head",)))
    return out


def whole_layers(model: torch.nn.Module, n: int) -> list:
    """The module names of the layers a model axis of ``n`` ranks leaves
    whole (``tp_groups`` whose count it does not divide, ``splits``)."""
    return [name for _, _, count, layers in tp_groups(model) if not splits(count, n) for name in layers]


def param_shardings(model: torch.nn.Module, mesh: Mesh) -> dict:
    """Each parameter's spec by torch name: a tuple of axis names or
    None per dimension; all None (replicated) at ``model == 1``, the
    tensor-parallel rules above a wider model axis, except in a layer the
    axis leaves whole (``whole_layers``: Swin-T's 3 stage-1 heads at 2),
    which stays replicated. ``parallel.tensor.param_slices`` gives each
    rank its slice of a split parameter (``split_positions``: ``qkv`` by
    heads)."""
    n = mesh.shape["model"]
    whole = set(whole_layers(model, n)) if n > 1 else set()
    # the rules match flax paths: a torch name with "/" for "."
    return {name: (None,) * p.ndim if name.rsplit(".", 1)[0] in whole else _spec_for(name.replace(".", "/"), p.ndim, n)
            for name, p in model.named_parameters()}


def zero1_shardings(model: torch.nn.Module, mesh: Mesh) -> dict:
    """The ZeRO-1 spec of each parameter's optimizer moments and EMA, by
    torch name: its ``param_shardings`` spec with ``"data"`` added on the
    largest evenly divisible dimension (``_add_axis``), as JAX's
    ``zero1_shardings`` gives the same leaf's ``opt_state`` and
    ``ema_params``. On a tensor-parallel model (``parallel.tensor``)
    its local shapes give the same spec: they differ from the whole ones
    only along the model axis, which ``_add_axis`` leaves alone."""
    base = param_shardings(model, mesh)
    n = mesh.shape["data"]
    return {name: _add_axis(tuple(p.shape), base[name], n, "data") for name, p in model.named_parameters()}
