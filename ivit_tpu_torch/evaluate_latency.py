"""Integer-only inference latency harness (PyTorch, one GPU).

Counterpart of the JAX package's ``evaluate_latency.py``, with its flags
where they mean the same thing:

    python -m ivit_tpu_torch.evaluate_latency --model deit_small --batch-size 1
    python -m ivit_tpu_torch.evaluate_latency --model swin_tiny

Without ``--artifact`` the engine runs a seeded synthetic artifact
(``deploy.synthetic_vit_artifact`` / ``deploy.synthetic_swin_artifact``,
seed 0; latency does not depend on the weights). ``--kernels`` is a comma
list of the engine's ``kernels=`` names (default: the engine's default;
an empty string runs the plain ops); the JAX CLI's batch-size auto-select
of its Pallas attention was measured on a TPU and does not carry over.

The "compile" step is ``deploy.graphs.capture_infer``: warm-up forwards,
then one forward captured as a CUDA graph, whose time it prints, with the
kernel launches of one forward. Then one warm call, ``--repeat`` replays
and a host readback, timed on the host clock, as the JAX CLI times its
compiled function. ``--device cpu`` runs the eager engine on the CPU
instead (for tests); without it the harness needs a CUDA device and
raises without one.
"""

from __future__ import annotations

import argparse
import time


def parse_kernels(text: str | None):
    """``--kernels`` as a tuple of names; ``None`` for the engine's default."""
    if text is None:
        return None
    return tuple(name.strip() for name in text.split(",") if name.strip())


def main(argv=None):
    p = argparse.ArgumentParser("I-ViT int8 latency harness (PyTorch)")
    p.add_argument("--model", default="deit_small")
    p.add_argument("--artifact", default="",
                   help="optional artifact; a seeded synthetic one if omitted (the reference harness also "
                        "times random params)")
    p.add_argument("--batch-size", default=1, type=int)
    p.add_argument("--input-size", default=224, type=int)
    p.add_argument("--nb-classes", default=1000, type=int)
    p.add_argument("--repeat", default=100, type=int)
    p.add_argument("--softmax-bits", default=16, type=int, choices=(8, 16),
                   help="ViT probability precision for the synthetic path (8 = the reference TVM deploy "
                        "precision)")
    p.add_argument("--gelu-stable", action="store_true",
                   help="elementwise-stable ShiftGELU for the synthetic path")
    p.add_argument("--kernels", default=None,
                   help="comma list of the engine's kernels= names (ViT: attention, attention2, softmax, "
                        "gelu, linear_gelu, layernorm, gelu_stable; Swin: attention, layernorm); default the "
                        "engine's default, '' the plain ops")
    p.add_argument("--device", default="cuda", help="cuda (a CUDA graph) or cpu (the eager engine)")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from .deploy import build_swin_infer, build_vit_infer, synthetic_swin_artifact, synthetic_vit_artifact
    from .core.device import target_device
    from .deploy.graphs import capture_infer
    from .utils import load_artifact

    device = target_device(args.device)
    is_swin = args.model.startswith("swin")
    if args.artifact:
        artifact = load_artifact(args.artifact)
    else:
        mk = dict(num_classes=args.nb_classes, img_size=args.input_size, gelu_stable=args.gelu_stable)
        if is_swin:
            artifact = synthetic_swin_artifact(args.model, seed=0, **mk)
        else:
            artifact = synthetic_vit_artifact(args.model, seed=0, softmax_bits=args.softmax_bits, **mk)
    size = artifact["config"]["img_size"]
    build_infer = build_swin_infer if is_swin else build_vit_infer
    kernels = parse_kernels(args.kernels)
    infer = build_infer(artifact, device) if kernels is None else build_infer(artifact, device, kernels=kernels)
    print(f"engine: kernels {sorted(infer.kernels)}")

    images = torch.from_numpy(
        np.random.default_rng(0).standard_normal((args.batch_size, size, size, 3)).astype(np.float32)
    ).to(device)
    if device.type == "cuda":
        t0 = time.perf_counter()
        compiled = capture_infer(infer, args.batch_size, size, device)
        print(f"capture: {time.perf_counter() - t0:.1f}s (CUDA graph; launches a forward {compiled.launches})")
    else:
        compiled = infer

    # the final host readback waits for the device
    float(compiled(images)[0, 0])
    t0 = time.perf_counter()
    for _ in range(args.repeat):
        out = compiled(images)
    float(out[0, 0])
    dt = (time.perf_counter() - t0) / args.repeat
    print(
        f"{args.model} int8 batch={args.batch_size}: "
        f"{dt*1e3:.3f} ms/iter, {args.batch_size/dt:.1f} img/s"
    )
    return dt


if __name__ == "__main__":
    main()
