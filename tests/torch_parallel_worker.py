"""Rank workers of the port's multi-process tests, on the CPU and on the
card (``tests/test_torch_cuda_ranks.py``, the exports of
``tests/test_torch_cuda.py``).

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
    mesh = make_mesh(*mesh_shape)
    infer = shard_infer_tp(artifact, mesh)
    x = torch.from_numpy(images).to(mesh.device)
    infer(x)  # builds and loads the kernels
    logits, launches = count_launches(infer, x)
    out = {"logits": logits.cpu().numpy(), "launches": launches, "device": str(mesh.device),
           "kernels": sorted(infer.kernels)}
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
    rank's rows), ranges and metrics, the parameters after step 1 and the
    final parameters, EMA and moments gathered whole, with this rank's
    moment shapes, all on the host."""
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
        if len(out["steps"]) == 1:  # the parameters after step 1, whole
            out["params1"] = {n: p.detach().cpu().clone()
                              for n, p in gather_train_state(state).model.named_parameters()}
    hook.remove()
    out["scales"] = {n: s.cpu() for n, s in out["scales"].items()}
    out["local_mu"] = {n: tuple(m.shape) for n, m in zip(names, state.opt_state.mu)}
    whole = gather_train_state(state)
    wnames = [n for n, _ in whole.model.named_parameters()]
    out["params"] = {n: p.detach().cpu().clone() for n, p in whole.model.named_parameters()}
    out["buffers"] = {n: b.cpu().clone() for n, b in whole.model.named_buffers()}
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


# ---- ranks sharing the card over gloo (tests/test_torch_cuda_ranks.py) ----------------------------

ROUTE_B = ("layernorm", "softmax", "gelu")


def count_launches(fn, *args):
    """``fn(*args)`` and the kernel launches it made, every count set to 0
    just before it and read just after."""
    from ivit_tpu_torch.kernels import WRAPPERS

    for w in WRAPPERS.values():
        w.launches = 0
    out = fn(*args)
    torch.cuda.synchronize()
    return out, {k: w.launches for k, w in WRAPPERS.items() if w.launches}


def _max_err(out, ref) -> float:
    pairs = zip(out, ref) if isinstance(out, tuple) else [(out, ref)]  # K6: (hi, lo)
    return max(float((a.double() - b.double()).abs().max()) for a, b in pairs)


def vit_kernel_errors(infer, images) -> dict:
    """K3 on block 0's norm1 input (full rows) and K1 on its q, k, v (this
    rank's heads under tensor parallelism) of a ViT engine, each against
    its plain version: the largest difference by kernel."""
    from ivit_tpu_torch.deploy.engine import attention_inputs, embed
    from ivit_tpu_torch.kernels import (
        fused_int8_attention,
        fused_int8_attention_reference,
        fused_layernorm_requant,
        fused_layernorm_requant_reference,
    )

    t, cfg = infer.tensors, infer.tensors["config"]
    x = embed(images, t)
    blk = t["blocks"][0]
    norm = (x.reshape(-1, cfg["embed_dim"]), blk["norm1"]["bias_int"], blk["norm1"]["ratio"])
    a = blk["attn"]
    attn = (*attention_inputs(x, blk, blk.get("heads", cfg["num_heads"])), a["r1"], a["scale"], a["r_out"],
            int(cfg["softmax_bits"]))
    return {"K3": _max_err(fused_layernorm_requant(*norm), fused_layernorm_requant_reference(*norm)),
            "K1": _max_err(fused_int8_attention(*attn), fused_int8_attention_reference(*attn))}


def swin_kernel_errors(infer, images) -> dict:
    """K3 on stage 1 block 0's norm1 input and K7 on the first two blocks
    of every stage (this rank's heads under tensor parallelism; a shifted
    block's key says ``masked``) of a Swin engine, each against its plain
    version: the largest difference by kernel. The trunk runs the blocks'
    collectives."""
    from ivit_tpu_torch.deploy.swin_engine import patch_embed, swin_trunk, window_attention_inputs
    from ivit_tpu_torch.kernels import (
        fused_int8_window_attention,
        fused_int8_window_attention_reference,
        fused_layernorm_requant,
        fused_layernorm_requant_reference,
    )

    ts = infer.tensors
    where = {id(b): (i, j) for i, stage in enumerate(ts["stages"]) for j, b in enumerate(stage["blocks"][:2])}
    errs = {}

    def visit(layer, x):
        if id(layer) not in where:
            return
        i, j = where[id(layer)]
        if (i, j) == (0, 0):
            norm = (x.reshape(-1, x.shape[-1]), layer["norm1"]["bias_int"], layer["norm1"]["ratio"])
            errs["K3 stage 1"] = _max_err(fused_layernorm_requant(*norm), fused_layernorm_requant_reference(*norm))
        a = layer["attn"]
        args = (*window_attention_inputs(x, layer, kernels=()), a["bias"], a["mask"], a["r1"], a["rb"], a["scale"],
                a["r_out"], layer["heads"])
        key = f"K7 stage {i + 1} block {j}" + (" masked" if a["mask"] is not None else "")
        errs[key] = _max_err(fused_int8_window_attention(*args), fused_int8_window_attention_reference(*args))

    swin_trunk(patch_embed(images, ts), ts, infer.kernels, on_layer=visit)
    return errs


def serve_paths_on_card(art8: dict, art16: dict, swin: dict, images) -> dict:
    """The published paths on this rank of a world sharing the card: the
    DeiT-S main path data-parallel at the images' batch and
    tensor-parallel at that batch and at 1, route B and Swin-T
    tensor-parallel, each forward's logits and launches; whether route A
    (K4) under a model axis raises; K1, K3, K5, K6 and K7 (each stage's
    first two blocks) against their plain versions on this rank's own
    inputs."""
    from ivit_tpu_torch.deploy.engine import _layernorm, attention_half, attention_inputs, embed, int8_linear
    from ivit_tpu_torch.kernels import (
        fused_requant_shiftgelu,
        fused_requant_shiftgelu_reference,
        fused_requant_shiftmax,
        fused_requant_shiftmax_reference,
    )

    world = dist.get_world_size()
    dp, tp = make_mesh(world, 1), make_mesh(1, world)
    dev = tp.device
    x = torch.from_numpy(images).to(dev)
    main_tp = shard_infer_tp(art8, tp)
    b_tp = shard_infer_tp(art16, tp, kernels=ROUTE_B)
    swin_tp = shard_infer_tp(swin, tp, build_fn=build_swin_infer)
    main_tp(x[:1])  # builds and loads the kernels
    out = {"device": str(dev), "paths": {}}
    for label, fn, xs in (("main DP", shard_infer(build_vit_infer(art8, dev), dp), x), ("main TP", main_tp, x),
                          ("main TP batch 1", main_tp, x[:1]), ("B TP", b_tp, x), ("swin TP", swin_tp, x)):
        logits, launches = count_launches(fn, xs)
        out["paths"][label] = (logits.cpu(), launches)
    try:
        shard_infer_tp(art16, tp, kernels=("layernorm", "attention2", "linear_gelu"))
        out["k4_raises"] = False
    except ValueError:
        out["k4_raises"] = True
    with torch.inference_mode():
        errs = vit_kernel_errors(main_tp, x)
        t = b_tp.tensors
        N = (t["config"]["img_size"] // t["config"]["patch_size"]) ** 2 + 1
        xb = embed(x, t)
        blk = t["blocks"][0]
        q, k, _ = attention_inputs(xb, blk, blk["heads"], b_tp.kernels)
        scores = torch.matmul(q.double(), k.double().transpose(-1, -2)).to(torch.int32).view(-1, N)
        a = blk["attn"]
        errs["K6"] = _max_err(fused_requant_shiftmax(scores, a["r1"], a["scale"], N),
                              fused_requant_shiftmax_reference(scores, a["r1"], a["scale"], N))
        h = attention_half(xb, blk, t["config"], b_tp.kernels)  # proj's all-reduce
        acc = int8_linear(_layernorm(h, blk["norm2"], b_tp.kernels), blk["fc1"])  # fc1's all-gather
        gelu = (acc, blk["fc1"]["ratio"], blk["gelu"]["s_in"], blk["gelu"]["r2"])
        errs["K5"] = _max_err(fused_requant_shiftgelu(*gelu), fused_requant_shiftgelu_reference(*gelu))
        errs.update(swin_kernel_errors(swin_tp, x))
    out["kernel_errors"] = errs
    return out


def serve_tp_trained_on_card(spec: dict, mesh_shape: tuple, images) -> dict:
    """``tp_variant`` of ``spec`` on this rank (its steps, first gradient
    and parameters after step 1 returned), then the trained whole
    parameters and ranges frozen and served by ``shard_infer_tp`` on the
    same mesh: its logits and launches, the single-process engine's
    logits, and the kernels (K1 and K3; K3 and K7 by stage) on this rank's
    own inputs against their plain versions."""
    from ivit_tpu_torch.deploy import freeze_vit
    from ivit_tpu_torch.deploy.swin_engine import freeze_swin

    rec = tp_variant(spec, mesh_shape)
    mesh = make_mesh(*mesh_shape)
    dev = mesh.device
    swin = spec["model"].startswith("swin")
    model = create_model(spec["model"], dev, seed=0, **spec["model_kw"])
    variables = {"params": {n: p.to(dev) for n, p in rec["params"].items()},
                 "quant_stats": {n: b.to(dev) for n, b in rec["buffers"].items()}}
    art = (freeze_swin if swin else freeze_vit)(model, variables, dev)
    build = build_swin_infer if swin else build_vit_infer
    x = torch.from_numpy(images).to(dev)
    with torch.inference_mode():
        single = build(art, dev)(x).cpu()
        infer = shard_infer_tp(art, mesh, build_fn=build)
        infer(x[:1])  # builds and loads the kernels
        logits, launches = count_launches(infer, x)
        logits = logits.cpu()
        errs = (swin_kernel_errors if swin else vit_kernel_errors)(infer, x)
    return {"device": str(dev), "logits": logits, "single": single, "launches": launches, "kernel_errors": errs,
            "steps": rec["steps"], "grads": rec["grads"], "params1": rec["params1"]}


def _pp_run(model, dev, mesh, batches: list, n_micro: int) -> dict:
    """One pipelined QAT run on ``mesh`` (a ``Mesh`` of one rank without a
    process group: the single-stage step): the frozen logits of the first
    batch (the global batch's), its whole gradient, the steps' losses,
    the whole parameters after step 1, this rank's optimizer-state bytes
    and the whole EMA variables after the last step, on the host."""
    from ivit_tpu_torch.models.model_utils import eval_variables
    from ivit_tpu_torch.parallel import (
        from_pp_state,
        from_pp_variables,
        make_pp_train_step,
        pipeline_vit_forward,
        pp_gather,
        pp_rows,
        to_pp_state,
    )
    from ivit_tpu_torch.parallel.pipeline import pp_reduce_grads

    state = to_pp_state(create_train_state(model, AdamW(1e-3, weight_decay=0.05), ema_decay=0.9, device=dev), mesh)
    x, t = batches[0]
    with torch.no_grad():
        logits = pp_gather(pipeline_vit_forward(model, x, mesh, n_micro), mesh, n_micro)
    names, params = zip(*model.named_parameters())
    loss = soft_target_cross_entropy(pipeline_vit_forward(model, x, mesh, n_micro), pp_rows(t, mesh, n_micro))
    grads = list(torch.autograd.grad(loss, params, materialize_grads=True))
    model.pp.wait()
    grads = data_mean(pp_reduce_grads(grads, list(names), mesh), mesh)
    grads = from_pp_variables({"params": dict(zip(names, grads))}, model.pp.depth, mesh)["params"]
    rec = {"logits": logits.cpu(), "grads": {n: g.cpu() for n, g in grads.items()}, "loss": []}
    del grads, loss
    step = make_pp_train_step(model, mesh, n_micro, grad_clip=1.0, ema_decay=0.9)
    for i, (x, t) in enumerate(batches):
        _, met = step(state, x, t)
        rec["loss"].append(float(met["loss"]))
        if i == 0:
            rec["params1"] = {n: p.cpu().clone() for n, p in from_pp_state(state).model.named_parameters()}
    local = list(state.opt_state.mu) + list(state.opt_state.nu) + list(state.ema_params.values())
    rec["opt_bytes"] = sum(a.numel() * a.element_size() for a in local)
    variables = eval_variables(from_pp_state(state))
    rec["variables"] = {col: {n: v.cpu().clone() for n, v in tree.items()} for col, tree in variables.items()}
    return rec


def pipeline_on_card(name: str, model_kw: dict, batches: list, calib, images, n_micro: int) -> dict:
    """GPipe on two ranks sharing the card, a stage each: rank 0 first runs
    the single-process frozen forward and the single-stage step (pipe = 1;
    the other rank waits), then both run the pipeline on a ``(1, 2)``
    mesh from the same calibrated model. Rank 0 returns both runs and
    the pipe-trained model's EMA weights frozen and served whole by
    ``build_vit_infer`` at ``images``: its logits and launches, the plain
    engine's logits, and K1 and K3 on its inputs against their plain
    versions; every rank its optimizer-state bytes."""
    from ivit_tpu_torch.deploy import freeze_vit
    from ivit_tpu_torch.parallel import Mesh, make_pp_mesh

    dev = torch.device("cuda", torch.cuda.current_device())
    batches = [(torch.from_numpy(x).to(dev), torch.from_numpy(t).to(dev)) for x, t in batches]

    def calibrated():  # one train-mode forward sets every range; the pipeline keeps them frozen
        model = create_model(name, dev, seed=0, **model_kw)
        with torch.no_grad():
            model(torch.from_numpy(calib).to(dev), train=True)
        return model

    out = {"device": str(dev)}
    if dist.get_rank() == 0:
        model = calibrated()
        with torch.no_grad():
            out["forward"] = model(batches[0][0], train=False).cpu()
        out["single"] = _pp_run(model, dev, Mesh(1, 1, 0, dev, {}, axis="pipe"), batches, n_micro)
        del model
        torch.cuda.empty_cache()
    dist.barrier()
    rec = _pp_run(calibrated(), dev, make_pp_mesh(1, 2, device=dev), batches, n_micro)
    out["opt_bytes"] = rec["opt_bytes"]
    if dist.get_rank() == 0:
        out["pipe"] = rec
        variables = {col: {n: v.to(dev) for n, v in tree.items()} for col, tree in rec["variables"].items()}
        art = freeze_vit(create_model(name, dev, seed=0, **model_kw), variables, dev)
        infer = build_vit_infer(art, dev)
        x = torch.from_numpy(images).to(dev)
        with torch.inference_mode():
            infer(x[:1])  # builds and loads the kernels
            logits, launches = count_launches(infer, x)
            out["served"] = {"logits": logits.cpu(), "plain": build_vit_infer(art, dev, kernels=())(x).cpu(),
                             "launches": launches, "kernel_errors": vit_kernel_errors(infer, x)}
    dist.barrier()
    return out



def export_engines(groups: list) -> list:
    """This rank's group of ``groups``, each ``(artifact, build options,
    [(batch, file), ...])``: the artifact's engine built once on the card
    (``build_swin_infer`` for a Swin artifact, else ``build_vit_infer``,
    given the options) and exported at each batch to its file by
    ``deploy.export_engine``. Returns the files written."""
    from ivit_tpu_torch.deploy.export import export_engine

    artifact, options, files = groups[dist.get_rank()]
    build = build_swin_infer if "depths" in artifact["config"] else build_vit_infer
    fn = build(artifact, torch.device("cuda", torch.cuda.current_device()), **options)
    for batch, path in files:
        export_engine(fn, batch, artifact["config"]["img_size"], path=path)
    return [path for _, path in files]
