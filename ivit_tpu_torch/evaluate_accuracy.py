"""Evaluate the integer-only engine's accuracy (PyTorch, one GPU).

Counterpart of the JAX package's ``evaluate_accuracy.py``, with its
flags: a sequential sweep of the validation set through the engine
(``build_vit_infer`` or ``build_swin_infer`` with their default
kernels), top-1 and top-5, a ``[seen] top1 … top5 …`` line every 20
batches and the ``FINAL`` line:

    python -m ivit_tpu_torch.evaluate_accuracy --model deit_small \\
        --artifact results/artifact.pkl --data /path/to/imagenet

On the card (``--device cuda``, the default; raises without one) the
engine runs as a CUDA graph captured at ``--batch-size``
(``deploy.graphs.capture_infer``), and a smaller last batch is padded
with copies of its own images, whose logits are cut off; ``--device
cpu`` runs the eager engine. ``--dump-logits`` saves the engine's
logits and labels in val order, image for image beside ``quant_train
--eval --dump-logits``.

``--mesh-data D --mesh-model M`` serve over ``D·M`` ranks, one process
per rank under ``torchrun`` (``nccl`` with a card per rank, ``gloo``
with ``--device cpu``), as the JAX CLI does: ``parallel.shard_infer``
(each data rank's rows through its own engine, captured as a CUDA graph
at its share of ``--batch-size`` on the card) at ``M = 1``, else
``parallel.shard_infer_tp`` (the engine's layers split over the model
axis, eager). ``D·M`` must equal ``WORLD_SIZE``; under torchrun a world
of one runs the mesh path too. Only rank 0 prints and dumps.

    python -m torch.distributed.run --standalone --nproc-per-node 2 \
        -m ivit_tpu_torch.evaluate_accuracy --mesh-data 2 --artifact a.pkl ...

``--weight-args`` is TPU-only.
"""

from __future__ import annotations

import argparse
import os

_TPU_ONLY_ITEM = "ROADMAP.md §1 item 9 (not ported: TPU-only machinery)"


def main(argv=None):
    p = argparse.ArgumentParser("I-ViT int8 accuracy harness (PyTorch)")
    p.add_argument("--model", default="deit_small")
    p.add_argument("--artifact", required=True)
    p.add_argument("--data", default="/dataset/imagenet/")
    p.add_argument("--data-set", default="IMNET", choices=["IMNET", "CIFAR100", "SYNTHETIC"])
    p.add_argument("--batch-size", default=128, type=int)
    p.add_argument("--input-size", default=224, type=int)
    p.add_argument("--nb-classes", default=1000, type=int)
    p.add_argument("--num-workers", default=8, type=int)
    p.add_argument("--mesh-data", default=1, type=int, help="data-parallel ranks (under torchrun)")
    p.add_argument("--mesh-model", default=1, type=int, help="tensor-parallel ranks (under torchrun)")
    p.add_argument("--max-batches", default=0, type=int, help="0 = full validation set")
    p.add_argument("--dump-logits", default="",
                   help="save per-image engine logits + labels to this .npz (aligns image for image with "
                        "quant_train --eval --dump-logits: val order is sequential)")
    p.add_argument("--weight-args", action="store_true",
                   help=f"the JAX engine's weight-as-arguments build; {_TPU_ONLY_ITEM}")
    p.add_argument("--device", default="cuda", help="cuda (a CUDA graph) or cpu (the eager engine)")
    args = p.parse_args(argv)

    ranks = args.mesh_data * args.mesh_model
    world = int(os.environ.get("WORLD_SIZE", 1))
    if ranks != world:
        raise SystemExit(f"--mesh-data {args.mesh_data} x --mesh-model {args.mesh_model} = {ranks} ranks, but "
                         f"WORLD_SIZE is {world}: launch one process per rank with `python -m "
                         f"torch.distributed.run --nproc-per-node {ranks} -m ivit_tpu_torch.evaluate_accuracy ...`")
    if args.weight_args:
        raise SystemExit(f"--weight-args is TPU-only (it passes the artifact's buffers as jit arguments to keep "
                         f"XLA programs small) and is not ported: {_TPU_ONLY_ITEM}")

    import torch

    joined = None
    if "WORLD_SIZE" in os.environ:
        from .parallel import init_distributed

        try:
            joined = init_distributed(device=args.device)
        except RuntimeError as e:
            raise SystemExit(f"--mesh-data/--mesh-model: {e}") from None
    try:
        return _evaluate(args, joined)
    finally:
        if joined is not None:
            torch.distributed.destroy_process_group()


def _evaluate(args, joined):
    import numpy as np
    import torch

    from .core.device import target_device
    from .data import DataLoader, ShuffleSampler, build_dataset
    from .data.transforms import EvalTransform
    from .deploy import build_swin_infer, build_vit_infer
    from .deploy.graphs import capture_infer
    from .parallel import make_mesh, shard_infer, shard_infer_tp
    from .utils import load_artifact

    device = target_device(args.device if joined is None else joined.device)
    lead = joined is None or joined.rank == 0
    say = print if lead else (lambda *a, **k: None)
    artifact = load_artifact(args.artifact)
    build_infer = build_swin_infer if args.model.startswith("swin") else build_vit_infer
    rows = -(-args.batch_size // args.mesh_data)  # each data rank's share of a (padded) batch
    if joined is None:
        infer = build_infer(artifact, device)
        say(f"engine: kernels {sorted(infer.kernels)}")
    elif args.mesh_model == 1:
        mesh = make_mesh(data=args.mesh_data, model=1, device=device)
        infer = build_infer(artifact, device)
    else:
        mesh = make_mesh(data=args.mesh_data, model=args.mesh_model, device=device)
        infer = shard_infer_tp(artifact, mesh, build_fn=build_infer)
    if joined is not None:
        say(f"engine: kernels {sorted(infer.kernels)}; mesh data={args.mesh_data} model={args.mesh_model} over "
            f"{joined.backend}")
    if device.type == "cuda" and args.mesh_model == 1:
        infer = capture_infer(infer, rows, artifact["config"]["img_size"], device)
        say(f"capture: CUDA graph at batch {rows}; launches a forward {infer.launches}")
    if joined is not None and args.mesh_model == 1:
        infer = shard_infer(infer, mesh)

    ds = build_dataset(args.data_set, args.data, False, args.input_size, args.nb_classes)
    loader = DataLoader(ds, args.batch_size, EvalTransform(size=args.input_size),
                        sampler=ShuffleSampler(len(ds), shuffle=False), drop_last=False,
                        num_workers=args.num_workers)

    top1 = top5 = seen = 0
    dumped_logits, dumped_labels = [], []
    for b, (images, labels) in enumerate(loader):
        if args.max_batches and b >= args.max_batches:
            break
        n = len(labels)
        # the graph's static batch, or a multiple of the data axis: pad
        # with the batch's own images (modular: pad can exceed n)
        pad = rows * args.mesh_data - n if device.type == "cuda" and args.mesh_model == 1 else -n % args.mesh_data
        if pad:
            images = np.concatenate([images, images[np.arange(pad) % n]])
        logits = infer(torch.from_numpy(images).to(device))[:n].cpu().numpy()
        if args.dump_logits:
            dumped_logits.append(logits)
            dumped_labels.append(np.asarray(labels))
        order = np.argsort(logits, -1)
        top1 += int((order[:, -1] == labels).sum())
        top5 += int((order[:, -5:] == labels[:, None]).any(-1).sum())
        seen += len(labels)
        if b % 20 == 0:
            say(f"[{seen}] top1 {100*top1/seen:.3f} top5 {100*top5/seen:.3f}")
    say(f"FINAL top1 {100*top1/seen:.3f} top5 {100*top5/seen:.3f} over {seen}")
    if args.dump_logits and lead:
        np.savez(args.dump_logits, logits=np.concatenate(dumped_logits), labels=np.concatenate(dumped_labels))
        say(f"dumped {seen} engine logits to {args.dump_logits}")
    return top1, top5, seen


if __name__ == "__main__":
    main()
