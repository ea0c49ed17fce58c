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
  {1, 3};
* ``shard_infer`` is data-parallel serving: each data rank runs the
  unchanged engine on its rows of the global batch and the logits are
  all-gathered, so they equal the single-process engine's bit for bit;
* ``zero1_shardings`` says along which dimension each rank holds its
  slice of the optimizer moments and of the EMA (``_add_axis``: the
  largest evenly divisible one); ``parallel.data`` runs the step on it.

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
    """A ``(data, model)`` grid of ranks with a process group per row and
    column. ``shape`` and ``coords`` are dicts by axis name; ``device``
    is this rank's device. The collectives take an axis name; on an axis
    of one rank without a process group they return their input."""

    def __init__(self, data: int, model: int, rank: int, device, groups: dict):
        self.shape = {"data": data, "model": model}
        self.rank = rank
        self.coords = {"data": rank // model, "model": rank % model}
        self.device = torch.device(device)
        self.groups = groups

    def __repr__(self) -> str:
        return f"Mesh(data={self.shape['data']}, model={self.shape['model']}, rank={self.rank}, device={self.device})"

    def _staged(self, t: torch.Tensor, group) -> torch.Tensor:
        """A copy of ``t`` where the group's backend can reduce it: the
        host for ``gloo`` and a CUDA tensor."""
        if t.is_cuda and dist.get_backend(group) == "gloo":
            return t.detach().to("cpu", copy=True)
        return t.detach().clone()

    def all_reduce(self, t: torch.Tensor, axis: str, op: str = "sum") -> torch.Tensor:
        """``t`` reduced over ``axis``'s group (``op``: sum, min or max)."""
        group = self.groups.get(axis)
        if group is None:
            return t
        buf = self._staged(t, group)
        dist.all_reduce(buf, op=getattr(dist.ReduceOp, op.upper()), group=group)
        return buf.to(t.device)

    def all_gather(self, t: torch.Tensor, axis: str, dim: int = 0) -> torch.Tensor:
        """The group's equal-shaped ``t`` concatenated along ``dim`` in
        the order of their coordinate on ``axis``."""
        group = self.groups.get(axis)
        if group is None:
            return t
        buf = self._staged(t, group).contiguous()
        parts = [torch.empty_like(buf) for _ in range(self.shape[axis])]
        dist.all_gather(parts, buf, group=group)
        return torch.cat(parts, dim).to(t.device)

    def block(self, x, axis: str, dim: int = 0):
        """This rank's block of ``x`` (a tensor or an array) along ``dim``
        when ``x`` is split evenly over ``axis``."""
        n, i = self.shape[axis], self.coords[axis]
        size = x.shape[dim]
        if size % n:
            raise ValueError(f"{size} along dim {dim} is not divisible by the {axis} axis of {n} ranks")
        b = size // n
        index = [slice(None)] * x.ndim
        index[dim] = slice(i * b, (i + 1) * b)
        return x[tuple(index)]


def make_mesh(data: int | None = None, model: int = 1, backend: str | None = None, device=None) -> Mesh:
    """A ``(data, model)`` mesh over the ranks of the default process
    group (``data`` defaults to world / model), laid out row-major:
    rank = data index · model + model index. Every rank must call it,
    with the same arguments: it creates a group for each row (model)
    and each column (data), on ``backend`` (the default group's when
    None). Without a process group it is a mesh of one, whose
    collectives return their input; ``device`` is the mesh's device (the
    current card, or the CPU without one, when None)."""
    if dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
    else:
        world, rank = 1, 0
    if data is None:
        data = world // model
    if data * model != world:
        raise ValueError(f"mesh {data}x{model} != WORLD_SIZE {world} ranks")
    if device is None:
        device = torch.device("cuda", torch.cuda.current_device()) if torch.cuda.is_available() else "cpu"
    groups: dict = {}
    if dist.is_initialized():
        backend = backend or dist.get_backend()
        grid = np.arange(world).reshape(data, model)
        for axis, lines in (("model", grid), ("data", grid.T)):
            for line in lines:
                g = dist.new_group([int(r) for r in line], backend=backend)
                if rank in line:
                    groups[axis] = g
    return Mesh(data, model, rank, device, groups)


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


def param_shardings(model: torch.nn.Module, mesh: Mesh) -> dict:
    """Each parameter's spec by torch name: a tuple of axis names or
    None per dimension; all None (replicated) at ``model == 1``, the
    tensor-parallel rules above a wider model axis."""
    # the rules match flax paths: a torch name with "/" for "."
    return {n: _spec_for(n.replace(".", "/"), p.ndim, mesh.shape["model"]) for n, p in model.named_parameters()}


def zero1_shardings(model: torch.nn.Module, mesh: Mesh) -> dict:
    """The ZeRO-1 spec of each parameter's optimizer moments and EMA, by
    torch name: its ``param_shardings`` spec with ``"data"`` added on the
    largest evenly divisible dimension (``_add_axis``), as JAX's
    ``zero1_shardings`` gives the same leaf's ``opt_state`` and
    ``ema_params``."""
    base = param_shardings(model, mesh)
    n = mesh.shape["data"]
    return {name: _add_axis(tuple(p.shape), base[name], n, "data") for name, p in model.named_parameters()}
