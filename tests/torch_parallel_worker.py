"""Rank workers of the port's multi-process CPU tests.

``run_ranks(world, tmp_path, task, *args)`` spawns ``world`` processes
(``torch.multiprocessing``, spawn) that join a ``gloo`` group through a
``file://`` rendezvous in ``tmp_path`` (no TCP port, so parallel test
workers cannot collide), run ``task(*args)`` and return each rank's
result. This module imports torch and ``ivit_tpu_torch`` only, neither
JAX nor a test file, so a rank starts in seconds.
"""

from __future__ import annotations

import copy
import os
import pickle

import numpy as np
import torch
import torch.distributed as dist

from ivit_tpu_torch.deploy import build_swin_infer, build_vit_infer
from ivit_tpu_torch.models import create_model
from ivit_tpu_torch.nn import load_flax_variables
from ivit_tpu_torch.nn.quant import data_shard
from ivit_tpu_torch.parallel import (
    batch_shard,
    data_mean,
    gather_train_state,
    init_distributed,
    make_mesh,
    shard_infer,
    shard_infer_tp,
    shard_train_state,
)
from ivit_tpu_torch.train import AdamW, create_train_state, make_train_step, soft_target_cross_entropy


def run_ranks(world: int, tmp_path, task, *args, backend: str = "gloo", device: str = "cpu",
              timeout: float = 600.0) -> list:
    """Each rank's ``task(*args)`` over a group of ``world`` processes on
    ``backend`` and ``device`` (``parallel.init_distributed``'s rule:
    ranks share a card only over ``gloo``). Ranks still running after
    ``timeout`` seconds (a collective that never completes) are killed
    and ``TimeoutError`` raised."""
    import time

    import torch.multiprocessing as mp

    out = os.path.join(str(tmp_path), f"ranks_{task.__name__}_{backend}")
    os.makedirs(out, exist_ok=True)
    ctx = mp.start_processes(_entry, args=(world, os.path.join(out, "rendezvous"), task.__name__, args, out,
                                           backend, device), nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{task.__name__}: {world} ranks still running after {timeout} s")
    results = []
    for r in range(world):
        with open(os.path.join(out, f"{r}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    return results


def _entry(rank, world, init_file, name, args, out, backend, device):
    torch.set_num_threads(1)
    init_distributed(backend=backend, device=device, init_method=f"file://{init_file}", rank=rank,
                     world_size=world)
    try:
        result = globals()[name](*args)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out, f"{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def _carried_shapes(t: dict) -> dict:
    """Every carried weight's shape (its true width ``n`` where it is
    padded) by the artifact path JAX's ``tp_weight_shardings`` uses."""
    blocks = ([(f"stages/{i}/blocks/{j}", b) for i, s in enumerate(t["stages"]) for j, b in enumerate(s["blocks"])]
              if "stages" in t else [(f"blocks/{i}", b) for i, b in enumerate(t["blocks"])])
    out = {}
    for path, blk in blocks + [("", {"head": t["head"]})]:
        for name in ("qkv", "proj", "fc1", "fc2", "head"):
            if name in blk:
                w = blk[name]["w"]
                k = f"{path}/{name}/w".lstrip("/")
                out[k] = (w.shape[0], blk[name].get("n", w.shape[1]))
                if "n" in blk[name]:
                    out[k + ":padded"] = tuple(w.shape)
    return out


def serve(cases: list) -> list:
    """Each case's logits on this rank: ``{"family": "vit"|"swin",
    "route": "dp"|"tp", "mesh": (data, model), "artifact", "images",
    "kernels", "opts"}`` through ``shard_infer`` on the plain engine or
    ``shard_infer_tp``; with the carried weights' shapes under TP."""
    meshes, out = {}, []
    for c in cases:
        if c["mesh"] not in meshes:
            meshes[c["mesh"]] = make_mesh(*c["mesh"], device="cpu")
        mesh = meshes[c["mesh"]]
        build = build_swin_infer if c["family"] == "swin" else build_vit_infer
        if c["route"] == "dp":
            infer = shard_infer(build(c["artifact"], "cpu", kernels=c["kernels"], **c.get("opts", {})), mesh)
            shapes = None
        else:
            infer = shard_infer_tp(c["artifact"], mesh, build_fn=build, kernels=c["kernels"], **c.get("opts", {}))
            shapes = _carried_shapes(infer.tensors)
        out.append({"logits": infer(torch.from_numpy(c["images"])).numpy(), "shapes": shapes,
                    "coords": dict(mesh.coords)})
    return out


def serve_on_card(artifact: dict, images, mesh_shape: tuple, zero1_spec: dict | None = None) -> dict:
    """The tensor(×data)-parallel engine of ``artifact`` with its default
    kernels on this rank's card: the logits and the launches of one
    forward, every count set to 0 just before it and read just after;
    with ``zero1_spec`` also the parameters after one step of the
    single-process trainer and after one ZeRO-1 step on the mesh."""
    from ivit_tpu_torch.kernels import WRAPPERS

    mesh = make_mesh(*mesh_shape)
    infer = shard_infer_tp(artifact, mesh)
    x = torch.from_numpy(images).to(mesh.device)
    infer(x)  # builds and loads the kernels
    torch.cuda.synchronize()
    for w in WRAPPERS.values():
        w.launches = 0
    logits = infer(x)
    torch.cuda.synchronize()
    out = {"logits": logits.cpu().numpy(), "launches": {k: w.launches for k, w in WRAPPERS.items() if w.launches},
           "device": str(mesh.device), "kernels": sorted(infer.kernels)}
    if zero1_spec is not None:  # the single-process step, then the ZeRO-1 step on the mesh
        images, targets, seed = zero1_spec["batches"][0]
        images, targets = torch.from_numpy(images).to(mesh.device), torch.from_numpy(targets).to(mesh.device)
        for key, on in (("plain", None), ("zero1", mesh)):
            model = create_model(zero1_spec["model"], device=mesh.device, seed=0, **zero1_spec["model_kw"])
            state = create_train_state(model, AdamW(zero1_spec["lr"]), ema_decay=0.9, device=mesh.device)
            if on is not None:
                state = shard_train_state(state, on)
            make_train_step(model, ema_decay=0.9, mesh=on)(state, images, targets,
                                                           torch.Generator(device=mesh.device).manual_seed(seed))
            out[key] = {n: p.detach().cpu() for n, p in model.named_parameters()}
    return out


def _named(model) -> dict:
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def train_variant(spec: dict, zero1: bool, mesh) -> dict:
    """The data-parallel step of ``spec`` on this rank (ZeRO-1 with
    ``zero1``; with no ``mesh`` the single-process step on the global
    batch): the averaged gradient of the first batch, then every
    step's local logits, ranges and metrics, and the final parameters,
    EMA and moments gathered whole, with the local moments' shapes."""
    model = create_model(spec["model"], device="cpu", seed=0, **spec["model_kw"])
    if spec.get("variables") is not None:
        load_flax_variables(model, spec["variables"])
    state = create_train_state(model, AdamW(spec["lr"], weight_decay=spec["wd"]), ema_decay=spec["ema"],
                               device="cpu")
    if zero1:
        state = shard_train_state(state, mesh)
    step = make_train_step(model, ema_decay=spec["ema"], grad_clip=spec["clip"], mesh=mesh)
    logits = []
    hook = model.register_forward_hook(lambda mod, args, out: logits.append(out.detach().clone()))
    steps = []
    rows = (lambda a: a) if mesh is None else (lambda a: mesh.block(a, "data"))
    for i, (images, targets, gen_seed) in enumerate(spec["batches"]):
        x, t = torch.from_numpy(images), torch.from_numpy(targets)
        if i == 0:  # the (averaged) gradient, on a copy of the model
            probe = copy.deepcopy(model)
            with data_shard(None if mesh is None else batch_shard(mesh)):
                out = probe(rows(x), train=True, generator=torch.Generator().manual_seed(gen_seed))
            loss = soft_target_cross_entropy(out, rows(t))
            grads = list(torch.autograd.grad(loss, list(probe.parameters()), materialize_grads=True))
            if mesh is not None:
                grads = data_mean(grads, mesh)
            grads = {n: g.clone() for (n, _), g in zip(probe.named_parameters(), grads)}
        _, met = step(state, x, t, torch.Generator().manual_seed(gen_seed))
        steps.append({"logits": logits[-1], "ranges": {n: b.clone() for n, b in model.named_buffers()},
                      "loss": float(met["loss"]), "acc1": float(met["acc1"])})
    hook.remove()
    local_mu = {n: tuple(m.shape) for (n, _), m in zip(model.named_parameters(), state.opt_state.mu)}
    whole = gather_train_state(state)
    names = [n for n, _ in model.named_parameters()]
    return {"grads": grads, "steps": steps, "params": _named(model),
            "ema": {n: whole.ema_params[n].clone() for n in names} if whole.ema_params is not None else None,
            "mu": dict(zip(names, [m.clone() for m in whole.opt_state.mu])),
            "nu": dict(zip(names, [m.clone() for m in whole.opt_state.nu])), "local_mu": local_mu}


def train(specs: list) -> list:
    """``train_variant`` of each ``(spec, zero1)`` on a ``(data,)`` mesh
    of the world."""
    mesh = make_mesh(device="cpu")
    return [train_variant(spec, zero1, mesh) for spec, zero1 in specs]




def as_numpy(tree):
    if isinstance(tree, dict):
        return {k: as_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [as_numpy(v) for v in tree]
    return tree.numpy() if torch.is_tensor(tree) else np.asarray(tree)


def _weight_scales(model) -> dict:
    """Every ``QuantLinear``'s per-output-channel weight scale as its last
    forward quantized with (``QuantLinear.w_scale``), a column-parallel
    layer's gathered whole."""
    from ivit_tpu_torch.nn.quant import QuantLinear

    tp, out = getattr(model, "tp", None), {}
    for path, mod in model.named_modules():
        if not isinstance(mod, QuantLinear):
            continue
        s = mod.w_scale
        if mod.split is not None and not mod.split.rows:
            _, pos = tp.slices[f"{path}.kernel"]
            parts = tp.mesh.all_gather(s, "model", 0)
            s = torch.empty_like(parts).index_copy_(0, torch.cat(pos).to(parts.device), parts)
        out[path] = s.clone()
    return out


def tp_variant(spec: dict, mesh_shape) -> dict:
    """The tensor(×data)-parallel step of ``spec`` on this rank (``mesh_shape``
    ``(data, model)``; None: the single-process step on the global batch):
    ``spec["seq"]`` sequence parallelism, ``spec["zero1"]`` ZeRO-1,
    ``spec["remat"]`` recompute, on ``spec["device"]`` (the CPU by
    default; a card shared over ``gloo``). Returns step 1's weight scales
    and the first batch's gradient (whole), each step's logits (this data
    rank's rows), ranges and metrics, and the final parameters, EMA and
    moments gathered whole, with this rank's moment shapes, all on the
    host."""
    from ivit_tpu_torch.parallel import tensor_parallel

    dev = torch.device(spec.get("device", "cpu"))
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    mesh = None if mesh_shape is None else make_mesh(*mesh_shape, device=dev)
    remat = {"remat": True} if spec.get("remat") else {}  # a float model takes no remat
    model = create_model(spec["model"], device=dev, seed=0, **remat, **spec["model_kw"])
    if spec.get("variables") is not None:
        load_flax_variables(model, spec["variables"])
    state = create_train_state(model, AdamW(spec["lr"], weight_decay=spec["wd"]), ema_decay=spec["ema"],
                               device=dev)
    if mesh is not None and mesh.shape["model"] > 1:
        tensor_parallel(state, mesh, seq_parallel=spec.get("seq", False))
    if spec.get("zero1"):
        state = shard_train_state(state, mesh)
    tp = getattr(model, "tp", None)
    names = [n for n, _ in model.named_parameters()]
    out = {}
    rows = (lambda a: a) if mesh is None else (lambda a: mesh.block(a, "data"))
    # the first batch's gradient, the ranges put back after the forward
    images, targets, gen_seed = spec["batches"][0]
    saved = {n: b.clone() for n, b in model.named_buffers()}
    with data_shard(None if mesh is None else batch_shard(mesh)):
        logits = model(rows(torch.from_numpy(images).to(dev)), train=True,
                       generator=torch.Generator(device=dev).manual_seed(gen_seed))
    out["scales"] = _weight_scales(model)  # as step 1's forward quantizes: the same weights
    loss = soft_target_cross_entropy(logits, rows(torch.from_numpy(targets).to(dev)))
    grads = list(torch.autograd.grad(loss, list(model.parameters()), materialize_grads=True))
    # the eval step on the ranges that forward set, before any update
    from ivit_tpu_torch.models.model_utils import model_variables
    from ivit_tpu_torch.train import make_eval_step

    labels = torch.from_numpy(targets.argmax(-1)).to(dev)
    _, out["eval_logits"] = make_eval_step(model, return_logits=True, mesh=mesh)(
        model_variables(model), torch.from_numpy(images).to(dev), labels, len(labels))
    out["eval_logits"] = out["eval_logits"].cpu()
    with torch.no_grad():
        for n, b in model.named_buffers():
            b.copy_(saved[n])
        if mesh is not None:
            grads = data_mean(grads, mesh)
        if tp is not None:
            grads = [tp.join(g, n) for g, n in zip(tp.reduce_grads(grads, names), names)]
    out["grads"] = dict(zip(names, [g.cpu().clone() for g in grads]))
    step = make_train_step(model, ema_decay=spec["ema"], grad_clip=spec["clip"], mesh=mesh)
    seen = []
    hook = model.register_forward_hook(lambda mod, args, o: seen.append(o.detach().clone()))
    out["steps"] = []
    for images, targets, gen_seed in spec["batches"]:
        _, met = step(state, torch.from_numpy(images).to(dev), torch.from_numpy(targets).to(dev),
                      torch.Generator(device=dev).manual_seed(gen_seed))
        out["steps"].append({"logits": seen[-1].cpu(), "ranges": {n: b.cpu().clone() for n, b in model.named_buffers()},
                             "loss": float(met["loss"]), "acc1": float(met["acc1"])})
    hook.remove()
    out["scales"] = {n: s.cpu() for n, s in out["scales"].items()}
    out["local_mu"] = {n: tuple(m.shape) for n, m in zip(names, state.opt_state.mu)}
    whole = gather_train_state(state)
    wnames = [n for n, _ in whole.model.named_parameters()]
    out["params"] = {n: p.detach().cpu().clone() for n, p in whole.model.named_parameters()}
    out["ema"] = {n: whole.ema_params[n].cpu().clone() for n in wnames} if whole.ema_params is not None else None
    out["mu"] = dict(zip(wnames, [m.cpu().clone() for m in whole.opt_state.mu]))
    out["nu"] = dict(zip(wnames, [m.cpu().clone() for m in whole.opt_state.nu]))
    return out


def train_tp(cases: list) -> list:
    """``tp_variant`` of each ``(spec, mesh_shape)`` on this rank."""
    return [tp_variant(spec, mesh_shape) for spec, mesh_shape in cases]


def _pp_state(spec: dict, lr: float = 1e-3, depth: int | None = None):
    """A whole train state of ``spec``'s tiny ViT on the CPU with JAX's
    variables (or, at another ``depth``, its seeded init), AdamW and an
    EMA."""
    if depth is None:
        model = create_model("deit_tiny", device="cpu", seed=0, **spec["model_kw"])
        load_flax_variables(model, spec["variables"])
    else:
        model = create_model("deit_tiny", device="cpu", seed=0, **dict(spec["model_kw"], depth=depth))
    return create_train_state(model, AdamW(lr), ema_decay=0.9, device="cpu")


def _whole_tensors(state) -> dict:
    names = [n for n, _ in state.model.named_parameters()]
    out = {"params": {n: p.detach().clone() for n, p in state.model.named_parameters()},
           "buffers": {n: b.clone() for n, b in state.model.named_buffers()},
           "ema": {n: state.ema_params[n].clone() for n in names}}
    for slot in ("mu", "nu"):
        out[slot] = dict(zip(names, [t.clone() for t in getattr(state.opt_state, slot)]))
    return out


def pipeline_run(spec: dict) -> dict:
    """The pipeline of ``parallel.pipeline`` on this rank, for each
    ``(data, pipe, n_micro)`` of ``spec["cases"]`` on the first data·pipe
    ranks (the others idle): the global batch's frozen logits
    (``pp_gather``), the whole gradient of the mean soft-target loss
    (the replicated leaves summed over pipe, everything averaged over
    data), and whether the stage round trip of the whole state is exact;
    then ``spec["train"]``'s steps (the losses, this rank's parameter,
    moment and EMA names after the first, the whole parameters after the
    last) and the errors ``spec["errors"]``' cases raise."""
    from ivit_tpu_torch.parallel import (
        from_pp_state,
        from_pp_variables,
        make_pp_mesh,
        make_pp_train_step,
        pipeline_vit_forward,
        pp_gather,
        pp_rows,
        to_pp_state,
    )
    from ivit_tpu_torch.parallel.pipeline import pp_reduce_grads

    images, targets = torch.from_numpy(spec["images"]), torch.from_numpy(spec["targets"])
    rank = dist.get_rank()
    out = {"cases": {}, "errors": {}}
    for data, pipe, n_micro in spec["cases"]:
        mesh = make_pp_mesh(data, pipe, device="cpu", ranks=range(data * pipe))
        if mesh is None:
            continue
        state = _pp_state(spec)
        whole = _whole_tensors(state)
        to_pp_state(state, mesh)
        model = state.model
        back = _whole_tensors(from_pp_state(state))
        same = all(torch.equal(back[k][n], t) for k in whole for n, t in whole[k].items()) and all(
            list(back[k]) == list(whole[k]) for k in whole)
        with torch.no_grad():
            logits = pp_gather(pipeline_vit_forward(model, images, mesh, n_micro), mesh, n_micro)
        names, params = zip(*model.named_parameters())
        rows = pipeline_vit_forward(model, images, mesh, n_micro)
        loss = soft_target_cross_entropy(rows, pp_rows(targets, mesh, n_micro))
        grads = list(torch.autograd.grad(loss, params, materialize_grads=True))
        model.pp.wait()
        grads = data_mean(pp_reduce_grads(grads, list(names), mesh), mesh)
        grads = from_pp_variables({"params": dict(zip(names, grads))}, model.pp.depth, mesh)["params"]
        out["cases"][(data, pipe, n_micro)] = {"logits": logits, "grads": grads, "round_trip": same,
                                               "params": list(names)}
    train = spec.get("train")
    if train is not None:
        mesh = make_pp_mesh(*train["mesh"], device="cpu", ranks=range(train["mesh"][0] * train["mesh"][1]))
        if mesh is not None:
            state = _pp_state(spec, lr=train["lr"])
            to_pp_state(state, mesh)
            step = make_pp_train_step(state.model, mesh, train["n_micro"], grad_clip=1.0, ema_decay=0.9)
            losses, held = [], None
            for i in range(train["steps"]):
                _, met = step(state, images, targets)
                losses.append((float(met["loss"]), float(met["acc1"])))
                if i == 0:
                    held = {"params": [n for n, _ in state.model.named_parameters()],
                            "mu": len(state.opt_state.mu), "nu": len(state.opt_state.nu),
                            "ema": list(state.ema_params)}
            out["train"] = {"losses": losses, "held": held, "step": state.step,
                            "params": {n: p.detach().clone() for n, p in
                                       from_pp_state(state).model.named_parameters()}}
    for key, (data, pipe, n_micro, depth) in spec.get("errors", {}).items():
        mesh = make_pp_mesh(data, pipe, device="cpu", ranks=range(data * pipe))
        if mesh is None:
            continue
        try:
            state = _pp_state(spec, depth=None if depth == spec["model_kw"]["depth"] else depth)
            to_pp_state(state, mesh)
            pipeline_vit_forward(state.model, images, mesh, n_micro)
            out["errors"][key] = None
        except ValueError as e:
            out["errors"][key] = str(e)
    out["rank"] = rank
    return out
