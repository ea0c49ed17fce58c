"""The multi-device dry run: training, evaluation, serving, Swin and the
pipeline on one world of ranks.

Counterpart of ``dryrun_multichip`` in the JAX package's
``__graft_entry__.py``, its five phases at its sizes, run by every rank
of a ``torch.distributed`` world (one process a rank):

    python -m torch.distributed.run --standalone --nproc-per-node 4 \\
        -m ivit_tpu_torch.dryrun_multichip [--device cpu]

1. a depth-2 ViT (img 32, patch 8, embed 64, 4 heads, 16 classes,
   drop-path 0.1, ``remat``; sequence-parallel on a model axis of 2) on
   the ``(n / m, m)`` mesh, m = 2 where n is even and at least 4, else 1,
   tensor-parallel on its model axis, ZeRO-1, EMA 0.999, clip 1.0:
   4 AdamW steps on one batch, the loss falls;
2. the eval step on its EMA weights: finite metrics;
3. frozen, served by ``shard_infer`` over DP(n) and by ``shard_infer_tp``
   on the phase-1 mesh, both equal to the single-process engine bit for
   bit;
4. a Swin (img 16, patch 2, embed 16, depths (2, 2), heads (2, 4),
   window 4) on the phase-1 mesh for 3 steps: the loss falls;
5. the phase-1 ViT's EMA weights pipelined over a ``(n / 2, 2)`` ``(data,
   pipe)`` mesh: the forward equal to the sequential one bit for bit,
   then 4 pipelined steps in which the loss falls.

Rank 0 prints JAX's line for each phase. The ranks join over ``gloo``,
named explicitly, so on one card they share it (the collectives staged
through the host); ``--device cpu`` runs them on the CPU.
"""

from __future__ import annotations

import argparse

import torch

VIT = dict(img_size=32, patch_size=8, num_classes=16, embed_dim=64, depth=2, num_heads=4)
SWIN = dict(img_size=16, patch_size=2, num_classes=16, embed_dim=16, depths=(2, 2), num_heads=(2, 4), window_size=4)


def _check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"dryrun_multichip: {msg}")


def _falls(losses: list) -> bool:
    return all(torch.isfinite(torch.tensor(losses))) and losses[-1] < losses[0]


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """The five phases on this rank of a world of ``n_devices`` ranks
    (the default process group, joined); raises ``RuntimeError`` naming
    the phase that fails."""
    import torch.distributed as dist

    from .deploy import build_vit_infer, freeze_vit
    from .models import create_model
    from .models.model_utils import eval_variables
    from .parallel import (
        gather_train_state,
        make_mesh,
        make_pp_mesh,
        make_pp_train_step,
        pipeline_vit_forward,
        pp_gather,
        shard_infer,
        shard_infer_tp,
        shard_train_state,
        tensor_parallel,
        to_pp_state,
    )
    from .train import AdamW, create_train_state, make_eval_step, make_train_step

    world = dist.get_world_size() if dist.is_initialized() else 1
    _check(world == n_devices, f"{n_devices} devices asked for, the world has {world} ranks")
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    lead = not dist.is_initialized() or dist.get_rank() == 0

    def say(line: str) -> None:
        if lead:
            print(line, flush=True)

    # TP over 2 ranks when the mesh allows it, DP over the rest
    model_axis = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    mesh = make_mesh(n_devices // model_axis, model_axis, device=dev)
    model = create_model("deit_small", dev, seed=0, drop_path_rate=0.1, remat=True, **VIT)
    gen = torch.Generator().manual_seed(0)
    batch = mesh.shape["data"] * 2
    images = torch.randn((batch, 32, 32, 3), generator=gen).to(dev)
    targets = torch.nn.functional.one_hot(torch.randint(0, 16, (batch,), generator=gen), 16).float().to(dev)
    labels = torch.randint(0, 16, (batch,), generator=gen).to(dev)

    state = create_train_state(model, AdamW(1e-4), ema_decay=0.999, device=dev)
    if model_axis > 1:  # sequence parallelism on the model axis, as JAX's seq_constraint
        tensor_parallel(state, mesh, seq_parallel=True)
    shard_train_state(state, mesh)
    train_step = make_train_step(model, ema_decay=0.999, grad_clip=1.0, mesh=mesh)
    # a few steps on one batch: the sharded step must learn, not only run
    losses = []
    for i in range(4):
        state, metrics = train_step(state, images, targets, torch.Generator(device=dev).manual_seed(1 + i))
        losses.append(float(metrics["loss"]))
    _check(_falls(losses), f"phase 1: the loss did not fall: {losses}")
    say(f"dryrun_multichip({n_devices}): mesh={dict(mesh.shape)} zero1 opt/EMA sharding, "
        f"loss={losses[0]:.4f}->{losses[-1]:.4f}")

    # --- phase 2: the sharded eval step on the trained state's EMA
    emetrics = make_eval_step(model, mesh=mesh)(eval_variables(state), images, labels, batch - 1)
    _check(all(bool(torch.isfinite(v)) for v in emetrics.values()), f"phase 2: {emetrics}")
    say(f"dryrun_multichip eval: acc1={float(emetrics['acc1']):.2f} acc5={float(emetrics['acc5']):.2f}")

    # --- phase 3: freeze -> DP- and TP-sharded int8 engines, bit-identical
    variables = eval_variables(gather_train_state(state))
    artifact = freeze_vit(create_model("deit_small", dev, seed=0, **VIT), variables, dev)
    infer = build_vit_infer(artifact, dev)
    with torch.inference_mode():
        single = infer(images)
        dp = shard_infer(infer, make_mesh(n_devices, 1, device=dev))(images)
        tp = shard_infer_tp(artifact, mesh)(images)
    _check(torch.equal(single, dp), "phase 3: DP-served logits differ from the single-process engine")
    _check(torch.equal(single, tp), "phase 3: TP-served logits differ from the single-process engine")
    say(f"dryrun_multichip engine: DP({n_devices}) and DPxTP{dict(mesh.shape)} logits bit-identical to "
        "single-device")

    # --- phase 4: a Swin's train step under the same mesh
    swin = create_model("swin_tiny", dev, seed=3, drop_path_rate=0.1, **SWIN)
    s_images = torch.randn((batch, 16, 16, 3), generator=torch.Generator().manual_seed(2)).to(dev)
    s_state = create_train_state(swin, AdamW(1e-4), ema_decay=0.999, device=dev)
    if model_axis > 1:
        tensor_parallel(s_state, mesh)
    s_step = make_train_step(swin, ema_decay=0.999, grad_clip=1.0, mesh=mesh)
    s_losses = []
    for i in range(3):
        s_state, s_metrics = s_step(s_state, s_images, targets, torch.Generator(device=dev).manual_seed(4 + i))
        s_losses.append(float(s_metrics["loss"]))
    _check(_falls(s_losses), f"phase 4: the Swin's loss did not fall: {s_losses}")
    say(f"dryrun_multichip swin: mesh={dict(mesh.shape)} loss={s_losses[0]:.4f}->{s_losses[-1]:.4f}")

    # --- phase 5: the phase-1 ViT pipelined over a (data, pipe) mesh
    pipe = 2
    pp_mesh = make_pp_mesh(n_devices // pipe, pipe, device=dev)
    pp_model = create_model("deit_small", dev, seed=0, **VIT)
    with torch.no_grad():
        for col, named in (("params", pp_model.named_parameters()), ("quant_stats", pp_model.named_buffers())):
            for name, t in named:
                t.copy_(variables[col][name])
        seq_logits = pp_model(images, train=False)
    pp_state = to_pp_state(create_train_state(pp_model, AdamW(1e-4), device=dev), pp_mesh)
    with torch.no_grad():
        pp_logits = pp_gather(pipeline_vit_forward(pp_model, images, pp_mesh, 2), pp_mesh, 2)
    _check(torch.equal(seq_logits, pp_logits), "phase 5: the pipelined forward differs from the sequential one")
    pp_step = make_pp_train_step(pp_model, pp_mesh, n_micro=2, grad_clip=1.0)
    pp_losses = []
    for _ in range(4):
        pp_state, pp_metrics = pp_step(pp_state, images, targets)
        pp_losses.append(float(pp_metrics["loss"]))
    _check(_falls(pp_losses), f"phase 5: the pipelined loss did not fall: {pp_losses}")
    say(f"dryrun_multichip pipeline: mesh={dict(pp_mesh.shape)} forward bit-identical; "
        f"loss={pp_losses[0]:.4f}->{pp_losses[-1]:.4f}")


def main(argv=None) -> None:
    p = argparse.ArgumentParser("dryrun_multichip (PyTorch)")
    p.add_argument("--device", default="cuda", help="cuda (the ranks share the host's cards over gloo) or cpu")
    args = p.parse_args(argv)
    import torch.distributed as dist

    from .parallel import init_distributed

    joined = init_distributed(backend="gloo", device=args.device)
    try:
        dryrun_multichip(joined.world_size, joined.device)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
