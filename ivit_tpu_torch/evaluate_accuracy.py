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

``--mesh-data`` and ``--mesh-model`` above 1 exit with a message naming
the ``ROADMAP.md`` item that ports them; ``--weight-args`` is TPU-only.
"""

from __future__ import annotations

import argparse

_MULTI_GPU_ITEM = "ROADMAP.md §1 item 8 (multi-GPU)"
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
    p.add_argument("--mesh-data", default=1, type=int,
                   help=f"data-parallel inference; > 1 comes with {_MULTI_GPU_ITEM}")
    p.add_argument("--mesh-model", default=1, type=int,
                   help=f"tensor-parallel inference; > 1 comes with {_MULTI_GPU_ITEM}")
    p.add_argument("--max-batches", default=0, type=int, help="0 = full validation set")
    p.add_argument("--dump-logits", default="",
                   help="save per-image engine logits + labels to this .npz (aligns image for image with "
                        "quant_train --eval --dump-logits: val order is sequential)")
    p.add_argument("--weight-args", action="store_true",
                   help=f"the JAX engine's weight-as-arguments build; {_TPU_ONLY_ITEM}")
    p.add_argument("--device", default="cuda", help="cuda (a CUDA graph) or cpu (the eager engine)")
    args = p.parse_args(argv)

    if args.mesh_data > 1 or args.mesh_model > 1:
        raise SystemExit(f"--mesh-data/--mesh-model > 1 are not ported to ivit_tpu_torch yet: they come with "
                         f"{_MULTI_GPU_ITEM}")
    if args.weight_args:
        raise SystemExit(f"--weight-args is TPU-only (it passes the artifact's buffers as jit arguments to keep "
                         f"XLA programs small) and is not ported: {_TPU_ONLY_ITEM}")

    import numpy as np
    import torch

    from .core.device import target_device
    from .data import DataLoader, ShuffleSampler, build_dataset
    from .data.transforms import EvalTransform
    from .deploy import build_swin_infer, build_vit_infer
    from .deploy.graphs import capture_infer
    from .utils import load_artifact

    device = target_device(args.device)
    artifact = load_artifact(args.artifact)
    build_infer = build_swin_infer if args.model.startswith("swin") else build_vit_infer
    infer = build_infer(artifact, device)
    print(f"engine: kernels {sorted(infer.kernels)}")
    if device.type == "cuda":
        infer = capture_infer(infer, args.batch_size, artifact["config"]["img_size"], device)
        print(f"capture: CUDA graph at batch {args.batch_size}; launches a forward {infer.launches}")

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
        pad = args.batch_size - n if device.type == "cuda" else 0
        if pad:  # the graph's static batch: pad with the batch's own images
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
            print(f"[{seen}] top1 {100*top1/seen:.3f} top5 {100*top5/seen:.3f}")
    print(f"FINAL top1 {100*top1/seen:.3f} top5 {100*top5/seen:.3f} over {seen}")
    if args.dump_logits:
        np.savez(args.dump_logits, logits=np.concatenate(dumped_logits), labels=np.concatenate(dumped_labels))
        print(f"dumped {seen} engine logits to {args.dump_logits}")
    return top1, top5, seen


if __name__ == "__main__":
    main()
