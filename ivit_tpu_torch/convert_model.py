"""Convert a QAT checkpoint into a deployable integer artifact.

Counterpart of the JAX package's ``convert_model.py``, with its flags and
messages, on two inputs:

    python -m ivit_tpu_torch.convert_model --checkpoint results/checkpoint.pkl \\
        --output results/artifact.pkl
    python -m ivit_tpu_torch.convert_model --model deit_small \\
        --torch-checkpoint checkpoint.pth.tar --output results/artifact.pkl

``--checkpoint`` reads this project's QAT checkpoint (either package's
``quant_train`` writes it, in one format: ``utils.checkpoint``). The
model and its spec (``--model``, ``--softmax-bits``, ``--gelu-stable``,
``--nb-classes``, ``--input-size``, ``--window-size``) default to what
the checkpoint records; a flag that conflicts with the record exits with
the JAX CLI's message. The model's live weights and ranges are frozen by
``deploy.freeze_vit`` or ``deploy.freeze_swin`` on ``--device`` (default
``cuda``; raises without a card).

``--torch-checkpoint`` reads the reference's ``weight_integer`` / ``bias_integer`` /
``*_scaling_factor`` buffers (ViT/DeiT or Swin) through
``deploy.ingest_torch`` and writes the pickled artifact both packages'
engines read. ``--model`` names the head counts, which the buffers do not
hold.

The checkpoint is read with ``torch.load(path, map_location="cpu")``, as
on the JAX side. Since torch 2.6 that loads with ``weights_only=True``: a
checkpoint that pickles objects other than tensors and containers (the
reference's ``checkpoint.pth.tar`` may hold its ``argparse.Namespace``)
does not load, on either side.

``--export-engine PATH`` then writes the artifact's engine as a
serialized ``torch.export`` program (``deploy.export``), built on
``--device`` with the engine's default kernels and specialized to
``--export-batch`` images at the artifact's input size, as the JAX CLI
writes its StableHLO engine; ``deploy.load_engine(PATH)`` runs it.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    p = argparse.ArgumentParser("I-ViT artifact converter (PyTorch)")
    p.add_argument("--model", default=None,
                   help="model name (deit_small, swin_tiny, ...); defaults to the one recorded in the checkpoint "
                        "(deit_small for checkpoints predating the metadata). --torch-checkpoint needs it for "
                        "the head count(s), which the buffers do not hold")
    p.add_argument("--checkpoint", default=None, help="our QAT checkpoint (quant_train output)")
    p.add_argument("--torch-checkpoint", default=None,
                   help="the REFERENCE's trained checkpoint.pth.tar (ViT/DeiT or Swin family): its "
                        "weight_integer/bias_integer/*_scaling_factor buffers are ingested verbatim. "
                        "Requires --model for the head count(s); pass --input-size for a Swin not "
                        "trained at 224")
    p.add_argument("--output", default="results/artifact.pkl")
    p.add_argument("--nb-classes", default=None, type=int,
                   help="--checkpoint: defaults to the recorded value (1000 for checkpoints predating the "
                        "metadata); --torch-checkpoint reads the head's width from the buffers")
    p.add_argument("--input-size", default=None, type=int,
                   help="--checkpoint: defaults to the recorded value (224 before the metadata); "
                        "--torch-checkpoint: Swin's training resolution (default 224), ViT reads it from "
                        "the pos-embed")
    p.add_argument("--window-size", default=None, type=int,
                   help="--checkpoint: Swin window size, defaults to the recorded value (7 before the "
                        "metadata); --torch-checkpoint reads it from the rel-pos table")
    p.add_argument("--export-engine", default="",
                   help="also write a serialized engine (torch.export) of the artifact to this path")
    p.add_argument("--export-batch", default=1, type=int,
                   help="batch size the exported engine is built for")
    p.add_argument("--softmax-bits", default=None, type=int, choices=(8, 16),
                   help="ViT probability precision the checkpoint was trained with; defaults to the recorded "
                        "value (16 before the metadata)")
    p.add_argument("--gelu-stable", default=None, action="store_true",
                   help="elementwise-stable ShiftGELU (must match training; recorded in the artifact); "
                        "defaults to the recorded value")
    p.add_argument("--device", default="cuda",
                   help="where --checkpoint's model is frozen and --export-engine's engine is built: cuda "
                        "(raises without a card) or cpu")
    args = p.parse_args(argv)

    if (args.checkpoint is None) == (args.torch_checkpoint is None):
        raise SystemExit(
            "pass exactly one of --checkpoint (our QAT state) or "
            "--torch-checkpoint (the reference's checkpoint.pth.tar)"
        )
    artifact = _ingest_torch(args) if args.torch_checkpoint else _convert_checkpoint(args)
    if args.export_engine:
        _export_engine(args, artifact)
    return artifact


def _export_engine(args, artifact):
    """--export-engine: the artifact's engine on --device with its default
    kernels, serialized at --export-batch images."""
    from .deploy import build_swin_infer, build_vit_infer, export_engine

    build = build_swin_infer if "depths" in artifact["config"] else build_vit_infer
    export_engine(build(artifact, args.device), args.export_batch, artifact["config"]["img_size"],
                  path=args.export_engine)
    print(f"wrote {args.export_engine} (torch.export, batch {args.export_batch})")


def _resolve(flag_name, cli_value, recorded, default):
    """A spec-level model property the scales were trained under: the CLI
    value wins only when it agrees with the checkpoint's record (or
    nothing was recorded)."""
    if recorded is not None and cli_value is not None and cli_value != recorded:
        raise SystemExit(
            f"--{flag_name}={cli_value} conflicts with the "
            f"checkpoint, which was trained with "
            f"{flag_name}={recorded} (recorded by quant_train). "
            f"Drop the flag to use the recorded value."
        )
    if cli_value is not None:
        return cli_value
    return recorded if recorded is not None else default


def _convert_checkpoint(args):
    """--checkpoint: freeze our QAT state into an artifact."""
    from .deploy import freeze_swin, freeze_vit
    from .models import create_model
    from .nn import load_flax_variables
    from .utils import load_checkpoint_raw, save_artifact

    raw, extra = load_checkpoint_raw(args.checkpoint)
    if args.model is not None and extra.get("model") is not None and extra["model"] != args.model:
        raise SystemExit(f"--model={args.model} but the checkpoint was trained as {extra['model']!r}")
    model_name = args.model or extra.get("model") or "deit_small"
    is_swin = model_name.startswith("swin")
    recorded_sm = extra.get("softmax_bits")
    if recorded_sm == 16 and is_swin:
        # the legacy record of the ignored ViT flag (quant_train.check_resume_spec)
        recorded_sm = 8
    sm_bits = _resolve("softmax-bits", args.softmax_bits, recorded_sm, 16)
    gelu_stable = _resolve("gelu-stable", args.gelu_stable, extra.get("gelu_stable"), False)
    nb_classes = _resolve("nb-classes", args.nb_classes, extra.get("nb_classes"), 1000)
    input_size = _resolve("input-size", args.input_size, extra.get("input_size"), 224)
    window_size = _resolve("window-size", args.window_size, extra.get("window_size"), 7)

    kwargs = dict(num_classes=nb_classes, img_size=input_size)
    if is_swin:
        kwargs["window_size"] = window_size
    elif sm_bits != 16:
        kwargs["softmax_bits"] = sm_bits
    if gelu_stable:
        kwargs["gelu_stable"] = True
    model = create_model(model_name, args.device, **kwargs)
    load_flax_variables(model, {"params": raw["params"], "quant_stats": raw["quant_stats"]})
    artifact = (freeze_swin if is_swin else freeze_vit)(model, device=args.device)
    save_artifact(args.output, artifact)
    print(f"wrote {args.output} (epoch {extra.get('epoch', '?')}, best_acc1 {extra.get('best_acc1', '?')})")
    return artifact


def _ingest_torch(args):
    """--torch-checkpoint: deploy the reference's own trained state."""
    import torch

    from .deploy.ingest_torch import torch_swin_state_to_artifact, torch_vit_state_to_artifact, unwrap_state_dict
    from .models import create_config
    from .utils import save_artifact

    if args.model is None:
        raise SystemExit(
            "--torch-checkpoint requires a --model name (the head "
            "count is not recoverable from the buffers; the reference "
            "converter likewise takes --depth from the operator, "
            "TVM_benchmark/convert_model.py:160)"
        )
    is_swin = args.model.startswith("swin")
    num_heads = create_config(args.model)["num_heads"]
    sd = unwrap_state_dict(torch.load(args.torch_checkpoint, map_location="cpu"))
    if is_swin:
        artifact = torch_swin_state_to_artifact(
            sd,
            num_heads=num_heads,
            img_size=args.input_size or 224,
            gelu_stable=bool(args.gelu_stable),
        )
    else:
        artifact = torch_vit_state_to_artifact(
            sd,
            num_heads=num_heads,
            softmax_bits=args.softmax_bits or 16,
            gelu_stable=bool(args.gelu_stable),
        )
    save_artifact(args.output, artifact)
    c = artifact["config"]
    depth = c.get("depth") or "-".join(str(d) for d in c["depths"])
    print(f"wrote {args.output} (ingested reference checkpoint: "
          f"depth {depth}, dim {c['embed_dim']}, "
          f"img {c['img_size']}, classes {c['num_classes']})")
    return artifact


if __name__ == "__main__":
    main()
