"""Convert the reference's trained checkpoint into a deployable artifact.

The ``--torch-checkpoint`` path of the JAX package's ``convert_model.py``
(``:169-230``), with the same flags and messages:

    python -m ivit_tpu_torch.convert_model --model deit_small \\
        --torch-checkpoint checkpoint.pth.tar --output results/artifact.pkl

It reads the reference's ``weight_integer`` / ``bias_integer`` /
``*_scaling_factor`` buffers (ViT/DeiT or Swin) through
``deploy.ingest_torch`` and writes the pickled artifact both packages'
engines read. ``--model`` names the head counts, which the buffers do not
hold.

The checkpoint is read with ``torch.load(path, map_location="cpu")``, as
on the JAX side. Since torch 2.6 that loads with ``weights_only=True``: a
checkpoint that pickles objects other than tensors and containers (the
reference's ``checkpoint.pth.tar`` may hold its ``argparse.Namespace``)
does not load, on either side.

``--checkpoint`` (this project's own QAT state) comes with the QAT port,
and ``--export-engine`` with the serialized-engine slice: each exits with
a message, before any work.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    p = argparse.ArgumentParser("I-ViT artifact converter (PyTorch)")
    p.add_argument("--model", default=None,
                   help="model name (deit_small, swin_tiny, ...): gives the head count(s), which the "
                        "checkpoint's buffers do not hold")
    p.add_argument("--checkpoint", default=None,
                   help="our QAT checkpoint (quant_train.py output); comes with the QAT port")
    p.add_argument("--torch-checkpoint", default=None,
                   help="the REFERENCE's trained checkpoint.pth.tar (ViT/DeiT or Swin family): its "
                        "weight_integer/bias_integer/*_scaling_factor buffers are ingested verbatim. "
                        "Requires --model for the head count(s); pass --input-size for a Swin not "
                        "trained at 224")
    p.add_argument("--output", default="results/artifact.pkl")
    p.add_argument("--nb-classes", default=None, type=int,
                   help="--checkpoint only (the head's width is read from the buffers)")
    p.add_argument("--input-size", default=None, type=int,
                   help="Swin's training resolution (default 224); ViT reads it from the pos-embed")
    p.add_argument("--window-size", default=None, type=int,
                   help="--checkpoint only (Swin reads it from the rel-pos table)")
    p.add_argument("--export-engine", default="",
                   help="also export a serialized engine; comes with the export slice")
    p.add_argument("--export-batch", default=1, type=int,
                   help="batch size the exported engine is built for")
    p.add_argument("--softmax-bits", default=None, type=int, choices=(8, 16),
                   help="ViT probability precision the checkpoint was trained with (default 16)")
    p.add_argument("--gelu-stable", default=None, action="store_true",
                   help="elementwise-stable ShiftGELU (must match training; recorded in the artifact)")
    args = p.parse_args(argv)

    if (args.checkpoint is None) == (args.torch_checkpoint is None):
        raise SystemExit(
            "pass exactly one of --checkpoint (our QAT state) or "
            "--torch-checkpoint (the reference's checkpoint.pth.tar)"
        )
    if args.checkpoint is not None:
        raise SystemExit(
            "--checkpoint (our own flax QAT state) comes with the QAT port of "
            "ivit_tpu_torch; convert it with the JAX package's convert_model.py"
        )
    if args.export_engine:
        raise SystemExit(
            "--export-engine comes with the serialized-engine slice of ivit_tpu_torch; "
            "capture the engine at run time with ivit_tpu_torch.deploy.graphs.capture_infer"
        )
    _ingest_torch(args)


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


if __name__ == "__main__":
    main()
