"""GPipe pipeline parallelism over the ViT block trunk, on a ``(data, pipe)``
mesh.

Counterpart of ``ivit_tpu/parallel/pipeline.py``. JAX stacks the blocks'
variables on a depth axis sharded over ``pipe`` and runs the schedule as
one ``shard_map`` whose activations hop stage to stage by ``ppermute``.
Here every rank is a process (``parallel.mesh``) and the layout is the
modules themselves:

* **Stages.** Stage s (the rank's ``pipe`` coordinate) keeps the modules
  ``blocks_{s·L}`` … ``blocks_{(s+1)·L−1}`` (L = depth / S) with their
  parameters, AdamW moments and EMA (``to_pp_state``); the prologue
  (``qact_input``, ``patch_embed``, ``qact_embed``, ``cls_token``,
  ``pos_embed``, ``qact_pos``, ``qact1``) and the epilogue (``norm``,
  ``qact2``, ``head``) are replicated. ``from_pp_state`` gathers the
  stages' shares back into the whole state (a checkpoint's); the round
  trip is exact.
* **The schedule** (``pipeline_trunk``): microbatch m is rows
  ``[m·mB, (m+1)·mB)`` of the global batch, of which data rank d takes
  its ``Mesh.block`` (JAX's ``P(None, "data")``). The first stage runs
  the model's ``prologue`` on its rows, the last its ``epilogue``: the
  same pieces ``VisionTransformer.forward`` chains, so the two cannot
  drift apart. Stage s receives microbatch m's (q, scale) from stage
  s − 1, runs its blocks and sends the result on, every message a
  point-to-point ``isend``/``recv`` on the pipe group tagged by its
  microbatch (staged through the host for CUDA tensors over ``gloo``).
  The stages form a chain, not JAX's ring: nothing goes from S − 1 back
  to 0, and JAX's bubble ticks on garbage are not computed.
* **The backward** crosses the same hops the other way, inside the
  autograd Functions ``_Send`` (forward send, backward receive of the
  cotangent) and ``_Recv`` (the mirror pair); each stage's sends and
  receives of a step are chained in microbatch order, so the backward
  runs them in one order on both sides of a hop whatever the autograd
  engine's scheduling. The last stage broadcasts the logits over the
  pipe group (``_FromLast``), so every rank computes the same loss and
  every stage's backward starts from it.

Semantics, as JAX's: the model runs with FROZEN ranges (``train=False``
under autograd: no ``QuantAct`` moves, no dropout or drop-path mask is
drawn), so the pipelined forward equals the sequential one bit for bit;
the optimizer math stays local to each stage (``make_pp_train_step``).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..core.qtensor import QTensor
from ..ops.interp import div
from ..train.losses import soft_target_cross_entropy, topk_accuracy
from .data import GatheredModel, data_mean, slot_lists
from .mesh import Mesh, grid_mesh


def make_pp_mesh(data: int = 1, pipe: int = 2, backend: str | None = None, device=None, ranks=None) -> Mesh | None:
    """A ``(data, pipe)`` mesh: batch parallelism × depth partitioning,
    laid out as ``np.asarray(devices).reshape(data, pipe)`` lays JAX's:
    rank = data index · pipe + pipe index, a group per row (pipe) and
    column (data). ``parallel.mesh.grid_mesh`` says how ``ranks``,
    ``backend`` and ``device`` are taken (every rank of the world calls
    it; one outside ``ranks`` gets None)."""
    return grid_mesh(data, pipe, "pipe", backend, device, ranks)


def stage_blocks(depth: int, mesh: Mesh) -> range:
    """The indices of the blocks this rank's stage holds; ``ValueError``
    where the stages do not divide ``depth``."""
    S, s = mesh.shape["pipe"], mesh.coords["pipe"]
    if depth % S:
        raise ValueError(f"depth {depth} not divisible by {S} stages")
    L = depth // S
    return range(s * L, (s + 1) * L)


def _block_of(name: str) -> int | None:
    """The block index of a torch name (``blocks_3.attn...`` → 3), None
    outside the trunk."""
    head = name.split(".", 1)[0]
    return int(head[len("blocks_"):]) if head.startswith("blocks_") else None


def pp_shardings(names, depth: int, mesh: Mesh) -> dict:
    """Each name's placement (JAX's ``pp_shardings``): the ``pipe``
    coordinate of the stage that holds it, None for the replicated
    prologue and epilogue."""
    L = depth // mesh.shape["pipe"]
    stage_blocks(depth, mesh)  # the divisibility check
    return {n: (None if _block_of(n) is None else _block_of(n) // L) for n in names}


def _whole(share: dict, depth: int, mesh: Mesh) -> dict:
    """Every stage's entries of a dict keyed by torch names, from this
    stage's ``share`` (every rank of the pipe row calls it), in the whole
    model's order: the replicated entries around the trunk and every
    block in order between them. Every block holds the same leaves, so
    each stage's blocks go in one flat buffer of one size and one
    all-gather over ``pipe`` carries them."""
    own = stage_blocks(depth, mesh)
    S, L = mesh.shape["pipe"], len(own)
    leaves = [n.split(".", 1)[1] for n in share if _block_of(n) == own.start]
    blocks = {n: t for n, t in share.items() if _block_of(n) is not None}
    if S > 1:
        template = [share[f"blocks_{own.start}.{leaf}"] for leaf in leaves]
        flat = torch.cat([share[f"blocks_{i}.{leaf}"].detach().reshape(-1) for i in own for leaf in leaves])
        parts = mesh.all_gather(flat, "pipe").view(S, -1)
        for s in range(S):
            chunks = parts[s].split([t.numel() for t in template] * L)
            for j in range(L):
                for k, leaf in enumerate(leaves):
                    blocks[f"blocks_{s * L + j}.{leaf}"] = chunks[j * len(leaves) + k].view(template[k].shape)
    out = {}
    for n, t in share.items():
        if _block_of(n) is None:
            out[n] = t
        elif n == f"blocks_{own.start}.{leaves[0]}":  # the trunk's place in the order
            out.update((f"blocks_{i}.{leaf}", blocks[f"blocks_{i}.{leaf}"]) for i in range(depth) for leaf in leaves)
    return out


def from_pp_variables(pp_vars: dict, depth: int, mesh: Mesh) -> dict:
    """Whole ``{column: {torch name: tensor}}`` variables (parameters,
    ranges, gradients) from every stage's share of them (every rank of the
    pipe row calls it), the blocks in order."""
    return {col: _whole(tree, depth, mesh) for col, tree in pp_vars.items()}


@dataclasses.dataclass
class Pipeline:
    """A pipeline stage's layout (``model.pp``): the mesh, the whole
    model's depth, its parameter and buffer names in order, and the
    point-to-point sends still in flight (``wait`` completes them)."""

    mesh: Mesh
    depth: int
    names: tuple
    buffers: tuple
    pending: list = dataclasses.field(default_factory=list)

    def wait(self) -> None:
        """Complete every send in flight."""
        for work in self.pending:
            work.wait()
        self.pending.clear()

    def gather(self, state):
        """``from_pp_state``, as ``parallel.gather_train_state`` calls it."""
        return from_pp_state(state)


def to_pp_state(state, mesh: Mesh):
    """Make ``state`` (a whole ``train.TrainState`` of a QAT ViT) this
    rank's stage of a pipeline on ``mesh``, in place: the other stages'
    blocks leave the model, their moments and EMA the state; the
    prologue, the epilogue and their moments and EMA stay on every rank;
    ``state.model.pp`` is set. Every rank calls it on the same whole state.
    Returns ``state``."""
    from ..models.vit import VisionTransformer

    model = state.model
    if not isinstance(model, VisionTransformer):
        raise TypeError(f"the pipeline takes a QAT VisionTransformer (its blocks are one repeated module), not "
                        f"{type(model).__name__}")
    if model.tp is not None or model.pp is not None or state.zero1 is not None:
        raise ValueError("the pipeline manages its own (data, pipe) mesh: the model is tensor-parallel, "
                         "pipelined or ZeRO-1-sliced already")
    depth = len(model.blocks)
    own = stage_blocks(depth, mesh)
    names = tuple(n for n, _ in model.named_parameters())
    buffers = tuple(n for n, _ in model.named_buffers())
    placed = pp_shardings(names, depth, mesh)
    keep = [i for i, n in enumerate(names) if placed[n] in (None, mesh.coords["pipe"])]
    for i in range(depth):
        if i not in own:
            delattr(model, f"blocks_{i}")
    model.blocks = [model.get_submodule(f"blocks_{i}") for i in own]
    for slot in slot_lists(state.opt_state):
        full = getattr(state.opt_state, slot)
        setattr(state.opt_state, slot, [full[i] for i in keep])
    if state.ema_params is not None:
        state.ema_params = {names[i]: state.ema_params[names[i]] for i in keep}
    model.pp = Pipeline(mesh, depth, names, buffers)
    return state


def from_pp_state(state):
    """A whole copy of a pipeline stage's ``state`` in the single-process
    layout a checkpoint holds (the model a ``GatheredModel``): every
    stage's blocks, moments and EMA gathered over the pipe group. Every
    rank of the pipe row calls it."""
    pp = state.model.pp
    mesh, depth = pp.mesh, pp.depth
    local = [n for n, _ in state.model.named_parameters()]
    params = _whole({n: p.detach() for n, p in state.model.named_parameters()}, depth, mesh)
    buffers = _whole({n: b.detach() for n, b in state.model.named_buffers()}, depth, mesh)
    opt = dataclasses.replace(state.opt_state, **{
        slot: list(_whole(dict(zip(local, getattr(state.opt_state, slot))), depth, mesh).values())
        for slot in slot_lists(state.opt_state)})
    ema = None if state.ema_params is None else _whole(dict(state.ema_params), depth, mesh)
    model = GatheredModel({n: params[n] for n in pp.names}, {n: buffers[n] for n in pp.buffers})
    return dataclasses.replace(state, model=model, opt_state=opt, ema_params=ema)


def pp_rows(x: torch.Tensor, mesh: Mesh, n_micro: int) -> torch.Tensor:
    """This data rank's rows of a global batch ``x``, microbatch by
    microbatch: microbatch m is rows ``[m·mB, (m+1)·mB)`` and the rank
    takes its ``Mesh.block`` of each. ``ValueError`` where ``n_micro``
    does not divide the batch, or the data axis a microbatch."""
    B = x.shape[0]
    if B % n_micro:
        raise ValueError(f"batch {B} not divisible by {n_micro} microbatches")
    micro = x.reshape(n_micro, B // n_micro, *x.shape[1:])
    mine = mesh.block(micro, "data", dim=1)
    return mine.reshape(-1, *x.shape[1:])


def pp_gather(logits: torch.Tensor, mesh: Mesh, n_micro: int) -> torch.Tensor:
    """The global batch's logits on every rank from each data rank's
    ``pipeline_vit_forward`` rows (``pp_rows``' order), in batch order."""
    D = mesh.shape["data"]
    parts = mesh.all_gather(logits.detach().contiguous(), "data")  # (D · n_micro · r, C), data-major
    r = logits.shape[0] // n_micro
    return parts.view(D, n_micro, r, -1).transpose(0, 1).reshape(D * n_micro * r, -1)


# the tag of microbatch m's cotangent is BACKWARD_TAG + m (its activation's is m)
BACKWARD_TAG = 1 << 16


class _Send(torch.autograd.Function):
    """Forward: send microbatch ``tag``'s (q, scale) to the next stage;
    returns a zero token that chains this microbatch's send after the
    previous one's (``prev``), so the backward receives the cotangents in
    microbatch order, last first. Backward: receive q's cotangent from
    the next stage. The scale carries none: under frozen ranges it is the
    block's last ``QuantAct`` scale, a function of its range buffers that
    no parameter reaches (JAX's ``ppermute`` carries a zero cotangent for
    it), so only q's goes back."""

    @staticmethod
    def forward(ctx, q, scale, prev, pp, tag):
        ctx.pp, ctx.tag, ctx.shape, ctx.has_prev = pp, tag, q.shape, prev is not None
        pp.pending.append(pp.mesh.isend(torch.cat([q.reshape(-1), scale.reshape(1)]), "pipe", 1, tag))
        return q.new_zeros(())

    @staticmethod
    def backward(ctx, g):
        dq = ctx.pp.mesh.recv((math.prod(ctx.shape),), "pipe", 1, BACKWARD_TAG + ctx.tag).view(ctx.shape)
        return dq, None, (g if ctx.has_prev else None), None, None


class _Recv(torch.autograd.Function):
    """Forward: receive microbatch ``tag``'s (q, scale) from the previous
    stage, and a token that the next microbatch's ``_Recv`` takes as
    ``prev`` (so the backward sends in microbatch order, last first, as
    the previous stage's ``_Send`` receives). Backward: send q's
    cotangent back."""

    @staticmethod
    def forward(ctx, prev, pp, shape, tag):
        ctx.pp, ctx.tag = pp, tag
        n = math.prod(shape)
        buf = pp.mesh.recv((n + 1,), "pipe", -1, tag)
        scale = buf[n].clone()
        ctx.mark_non_differentiable(scale)
        return buf[:n].view(shape), scale, prev.new_zeros(())

    @staticmethod
    def backward(ctx, dq, dscale, g):
        ctx.pp.pending.append(ctx.pp.mesh.isend(dq.contiguous(), "pipe", -1, BACKWARD_TAG + ctx.tag))
        return g, None, None, None


class _FromLast(torch.autograd.Function):
    """The last stage's logits on every rank of the pipe group (a
    broadcast). Backward: the last stage passes its gradient on; the
    others give their token a zero gradient, which starts their
    ``_Send`` backward (each rank's loss is the same)."""

    @staticmethod
    def forward(ctx, t, pp, shape):
        mesh = pp.mesh
        last = mesh.shape["pipe"] - 1
        ctx.last = mesh.coords["pipe"] == last
        ctx.token = (t.shape, t.dtype, t.device)
        return mesh.broadcast(t if ctx.last else None, "pipe", last, shape)

    @staticmethod
    def backward(ctx, g):
        shape, dtype, device = ctx.token
        return (g if ctx.last else torch.zeros(shape, dtype=dtype, device=device)), None, None


def pipeline_trunk(model, x: QTensor | None, rows: int, n_micro: int) -> QTensor | torch.Tensor:
    """The GPipe trunk on this rank's stage of ``model`` (``to_pp_state``)
    for ``rows`` rows of this data rank (``pp_rows``), ``n_micro``
    microbatches of them. ``x``: the trunk's input on the first stage
    (the prologue's output), None on the others. Returns the trunk's
    output for the rows on the last stage, and on the others the token
    of its last send (its backward pulls the cotangents in)."""
    pp = model.pp
    mesh = pp.mesh
    S, s = mesh.shape["pipe"], mesh.coords["pipe"]
    if rows % n_micro:
        raise ValueError(f"{rows} rows not divisible by {n_micro} microbatches")
    r = rows // n_micro
    shape = (r, model.pos_embed.shape[1], model.config["embed_dim"])
    outs, token = [], None
    # the first receive hangs off a zero multiple of a parameter of this
    # stage: a gradient asked for the stage's parameters alone
    # (torch.autograd.grad prunes the rest) still runs every receive's
    # backward, whose cotangent the previous stage waits for
    recv_token = next(model.blocks[0].parameters()).reshape(-1)[0] * 0.0
    for m in range(n_micro):
        if s == 0:
            xm = QTensor(x.q[m * r:(m + 1) * r], x.scale, x.bits)
        else:
            q, scale, recv_token = _Recv.apply(recv_token, pp, shape, m)
            xm = QTensor(q, scale, 16)
        y = model.trunk(xm, train=False)
        if s < S - 1:
            token = _Send.apply(y.q, y.scale, token, pp, m)
        else:
            outs.append(y)
    if s < S - 1:
        return token
    # frozen ranges: every microbatch leaves at the same scale
    return QTensor(torch.cat([y.q for y in outs]), outs[0].scale, outs[0].bits)


def pipeline_vit_forward(model, images: torch.Tensor, mesh: Mesh, n_micro: int) -> torch.Tensor:
    """The pipelined forward of this rank's stage of ``model`` on a global
    batch ``images`` (every rank passes the same): the float logits of
    this data rank's rows (``pp_rows``' order), on every rank of its pipe
    row, differentiable. Equal bit for bit to the sequential frozen
    forward's on those rows (``pp_gather`` assembles the global batch's).
    Call ``model.pp.wait()`` after a backward through it."""
    pp = model.pp
    if pp is None or pp.mesh is not mesh:
        raise ValueError("pipeline_vit_forward runs a pipeline stage of this mesh: to_pp_state(state, mesh)")
    pp.wait()
    rows = pp_rows(images, mesh, n_micro)
    S, s = mesh.shape["pipe"], mesh.coords["pipe"]
    x = model.prologue(rows, train=False) if s == 0 else None
    y = pipeline_trunk(model, x, rows.shape[0], n_micro)
    if S == 1:
        return model.epilogue(y, train=False)
    out = model.epilogue(y, train=False) if s == S - 1 else y
    logits = _FromLast.apply(out, pp, (rows.shape[0], model.config["num_classes"]))
    if not torch.is_grad_enabled():
        pp.wait()
    return logits


@torch.no_grad()
def pp_reduce_grads(grads: list, names: list, mesh: Mesh) -> list:
    """``grads`` (a stage's, in ``names`` order) with every replicated
    leaf summed over the pipe group: the prologue's gradient arises on
    the first stage and the epilogue's on the last, zero elsewhere, so
    the sum is exact and each stage then holds the whole gradient."""
    at = [i for i, n in enumerate(names) if _block_of(n) is None]
    if mesh.groups.get("pipe") is None or not at:
        return grads
    flat = mesh.all_reduce(torch.cat([grads[i].reshape(-1) for i in at]), "pipe")
    out, k = list(grads), 0
    for i in at:
        out[i] = flat[k:k + grads[i].numel()].view(grads[i].shape)
        k += grads[i].numel()
    return out


@torch.no_grad()
def pp_global_norm(grads: list, names: list, mesh: Mesh) -> torch.Tensor:
    """‖g‖ over the whole model: each stage's blocks counted once (their
    squares summed over the pipe group), the replicated leaves once."""
    sq = torch.stack(torch._foreach_norm(grads)) ** 2
    block = torch.tensor([_block_of(n) is not None for n in names], device=sq.device)
    return torch.sqrt(mesh.all_reduce(sq[block].sum(), "pipe") + sq[~block].sum())


def make_pp_train_step(model, mesh: Mesh, n_micro: int, tx=None, grad_clip: float | None = None,
                       ema_decay: float = 0.0):
    """The pipelined train step of this rank's stage of ``model``
    (``to_pp_state``), with ``make_train_step``'s surface: ``(state,
    images, targets) → (state, metrics)``, every rank passing the same
    global batch and soft targets. The forward is
    ``pipeline_vit_forward`` (frozen ranges, no random draw), the loss
    the mean soft-target cross-entropy over the global batch; the
    replicated leaves' gradients are summed over the pipe group
    (``pp_reduce_grads``), then every gradient averaged over the data
    group; the clip takes the whole model's norm (``pp_global_norm``).
    ``tx`` (the state's own optimizer when None) and the EMA update this
    stage's share only. ``loss`` and ``acc1`` are the global batch's, the
    same on every rank."""

    def step(state, images: torch.Tensor, targets: torch.Tensor):
        names, params = zip(*model.named_parameters())
        logits = pipeline_vit_forward(model, images, mesh, n_micro)
        rows_t = pp_rows(targets, mesh, n_micro)
        loss = soft_target_cross_entropy(logits, rows_t)
        grads = list(torch.autograd.grad(loss, params, materialize_grads=True))
        model.pp.wait()
        with torch.no_grad():
            grads = data_mean(pp_reduce_grads(grads, list(names), mesh), mesh)
            if grad_clip is not None:
                gnorm = pp_global_norm(grads, list(names), mesh)
                torch._foreach_mul_(grads, torch.clamp(div(grad_clip, gnorm + 1e-6), max=1.0))
            (tx or state.tx).update(list(params), grads, state.opt_state)
            if state.ema_params is not None:
                ema = [state.ema_params[n] for n in names]
                torch._foreach_mul_(ema, ema_decay)
                torch._foreach_add_(ema, torch._foreach_mul(list(params), 1.0 - ema_decay))
            state.step += 1
            metrics = {"loss": loss.detach(), "acc1": topk_accuracy(logits.detach(), rows_t.argmax(-1), 1)}
            metrics = dict(zip(metrics, data_mean(list(metrics.values()), mesh)))
        return state, metrics

    return step
