"""I-ViT QAT fine-tuning CLI (PyTorch, one GPU).

Counterpart of the JAX package's ``quant_train.py``, with its flags and
defaults (epochs 90, lr 1e-6, batch 128, AdamW, cosine with min_lr
forced to lr/15, the DeiT augmentation recipe) and its single-device
loop: one train step a batch (``train.make_train_step``) on the SIM
model with straight-through gradients, validation every epoch,
``checkpoint.pkl`` every epoch and ``best.pkl`` on a new best, in the
JAX package's checkpoint format (``utils.checkpoint``), so a run may
resume from, or be converted after, either package's checkpoint:

    python -m ivit_tpu_torch.quant_train --model deit_small --data /path/to/imagenet
    python -m ivit_tpu_torch.quant_train --model deit_tiny --data-set SYNTHETIC \\
        --input-size 32 --nb-classes 10 --epochs 1 --device cpu

``--device`` (default ``cuda``; raises without a card) picks where the
step runs. Each step's random draws come from generators seeded by
``(seed, epoch, step)``: the mixup/cutmix draws (a numpy generator,
``train.augment.draw_mixup``) and drop-path (a torch generator), and the
loader seeds each sample by ``(seed, epoch, position, index)``; so a run
resumed at epoch e repeats the uninterrupted run's epoch e.
``--aa none --color-jitter 0`` runs the input pipeline without Pillow.

``--pretrained <path>`` imports a float checkpoint (torch ``.pth`` or
``.pth.tar``, augreg ``.npz``) into the QAT model after the state is
built, as JAX does; its activation ranges then start at zero, so pass
``--calib-batches``. ``--fast-matmul`` runs the exact dots' backward on
bf16-rounded operands (``nn.quant.SIM_FAST_MATMUL``) for the run. The
``*_fp32`` names train and evaluate the float models through the same
loop.

``--distributed`` runs data-parallel, one process per rank under
``torchrun`` (``parallel.init_distributed``: ``nccl`` with a card per
rank, ``gloo`` with ``--device cpu``), on a ``(data,)`` mesh of
``WORLD_SIZE`` ranks:

    python -m torch.distributed.run --standalone --nproc-per-node 4 \
        -m ivit_tpu_torch.quant_train --distributed --zero1 --model deit_small ...

Every rank reads the global batch the single-process loader reads
(``--batch-size`` is the global batch, a multiple of the world) and
runs its rows through the data-parallel step
(``train.make_train_step(..., mesh=)``): ranges, masks and mixup are
the global batch's, the gradients averaged. ``--zero1`` slices the
optimizer moments and the EMA over the ranks
(``parallel.shard_train_state``; alone, a mesh of one). Only rank 0
logs and writes checkpoints, gathered into the single-process layout,
so a run resumes under either.

``--mesh-model N`` adds a model axis: tensor parallelism on a ``(data,
model)`` mesh of ``WORLD_SIZE / N`` by ``N`` ranks
(``parallel.tensor_parallel``: attention by heads, the Mlp by hidden
columns, the head by classes; the QAT and the ``*_fp32`` models),
exiting where N does not divide the world; ``--seq-parallel`` splits the
tokens between the blocks' matmuls over that axis (ignored with a
warning without a model axis, for a Swin or for a float model, as JAX's
CLI does); ``--zero1`` slices the moments and the EMA of
each rank's tensor-parallel share over the data axis. Checkpoints hold
the whole state either way, and ``--resume`` under a model axis slices
it back.

    python -m torch.distributed.run --standalone --nproc-per-node 4 \
        -m ivit_tpu_torch.quant_train --distributed --mesh-model 2 --seq-parallel --zero1 ...

``--pipe N`` trains GPipe over a ``(WORLD_SIZE / N, N)`` ``(data,
pipe)`` mesh (``parallel.pipeline``: each rank holds the blocks of its
stage, the prologue and the epilogue whole) with JAX's frozen-range
finetune semantics: the ranges do not move and the step draws no
dropout or drop-path mask, so they must come from ``--calib-batches`` or
``--resume``; the optimizer state starts fresh; ``--pipe-microbatches``
(0: the largest M ≤ 2N that splits the batch into multiples of the data
axis) microbatches a step. JAX's guards exit first, in JAX's order and
words: a Swin, ``--mesh-model``/``--seq-parallel``/``--zero1``, a depth
N does not divide, no range source; then a world N does not divide.
Validation runs pipelined; checkpoints hold the whole state, with
``"pipe"`` in their record, and load into any run:

    python -m torch.distributed.run --standalone --nproc-per-node 4 \
        -m ivit_tpu_torch.quant_train --distributed --pipe 2 --calib-batches 4 ...

``--pretrained auto`` (a download) and ``--pretrained`` with a
``*_fp32`` name exit, each saying why; so does ``--distributed`` without
torchrun's environment.
"""

from __future__ import annotations

import argparse
import logging
import os
import signal
import time

def build_parser():
    p = argparse.ArgumentParser("I-ViT QAT (PyTorch)")
    p.add_argument("--model", default="deit_tiny",
                   help="deit_tiny|deit_small|deit_base|vit_base|vit_large|swin_tiny|swin_small|swin_base, or a "
                        "float baseline: the same names with _fp32")
    p.add_argument("--data", metavar="DIR", default="/dataset/imagenet/")
    p.add_argument("--data-set", default="IMNET", choices=["CIFAR100", "IMNET", "SYNTHETIC"])
    p.add_argument("--nb-classes", default=1000, type=int)
    p.add_argument("--input-size", default=224, type=int)
    p.add_argument("--print-freq", default=1000, type=int)
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--output-dir", type=str, default="results/")
    p.add_argument("--resume", default="")
    p.add_argument("--start-epoch", default=0, type=int)
    p.add_argument("--batch-size", default=128, type=int)
    p.add_argument("--epochs", default=90, type=int)
    p.add_argument("--num-workers", default=8, type=int)
    # regularization
    p.add_argument("--drop", type=float, default=0.0)
    p.add_argument("--drop-path", type=float, default=0.1)
    # EMA
    p.add_argument("--model-ema", action="store_true")
    p.add_argument("--model-ema-decay", type=float, default=0.99996)
    # optimizer
    p.add_argument("--opt", default="adamw", type=str)
    p.add_argument("--opt-eps", default=1e-8, type=float)
    p.add_argument("--opt-betas", default=None, type=float, nargs="+")
    p.add_argument("--clip-grad", type=float, default=None)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--weight-decay", type=float, default=1e-4)
    # schedule
    p.add_argument("--sched", default="cosine", type=str)
    p.add_argument("--lr", type=float, default=1e-6)
    p.add_argument("--warmup-lr", type=float, default=1e-6)
    p.add_argument("--min-lr", type=float, default=5e-7)
    p.add_argument("--warmup-epochs", type=int, default=0)
    # augmentation
    p.add_argument("--color-jitter", type=float, default=0.4,
                   help="colour jitter strength when RandAugment is off (needs Pillow; 0 turns it off)")
    p.add_argument("--aa", type=str, default="rand-m9-mstd0.5-inc1",
                   help="RandAugment policy (needs Pillow; 'none' turns it off)")
    p.add_argument("--smoothing", type=float, default=0.1)
    p.add_argument("--train-interpolation", type=str, default="bicubic")
    p.add_argument("--repeated-aug", action="store_true")
    p.add_argument("--reprob", type=float, default=0.25)
    p.add_argument("--loader-procs", action="store_true",
                   help="spawn worker PROCESSES for the input pipeline (sidesteps the GIL)")
    p.add_argument("--min-crop-scale", type=float, default=0.08, help="RandomResizedCrop lower scale bound")
    p.add_argument("--remode", type=str, default="pixel")
    p.add_argument("--recount", type=int, default=1)
    # mixup / cutmix
    p.add_argument("--mixup", type=float, default=0.8)
    p.add_argument("--cutmix", type=float, default=1.0)
    p.add_argument("--mixup-prob", type=float, default=1.0)
    p.add_argument("--mixup-switch-prob", type=float, default=0.5)
    p.add_argument("--mixup-mode", type=str, default="batch")
    p.add_argument("--best-acc1", type=float, default=0)
    # the JAX CLI's multi-device extras
    p.add_argument("--mesh-model", type=int, default=1,
                   help="tensor parallelism: the model axis of a (WORLD_SIZE / N, N) mesh (with --distributed)")
    p.add_argument("--seq-parallel", action="store_true",
                   help="sequence parallelism: the token axis split over the model axis between the blocks' matmuls "
                        "(needs --mesh-model > 1 and a ViT-family model)")
    p.add_argument("--pipe", type=int, default=1,
                   help="pipeline-parallel stages (with --distributed): the block trunk over a (WORLD_SIZE / N, N) "
                        "(data, pipe) mesh, GPipe schedule (parallel/pipeline.py; the forward bit-identical to "
                        "the sequential one). FROZEN-RANGE finetune semantics: activation ranges do not EMA-update "
                        "and the step graph is deterministic (no dropout/drop-path), so populate ranges first via "
                        "--calib-batches or --resume. ViT family; depth must divide by the stage count; exclusive "
                        "with --mesh-model/--seq-parallel/--zero1; optimizer state restarts fresh (not carried "
                        "from --resume)")
    p.add_argument("--pipe-microbatches", type=int, default=0,
                   help="GPipe microbatches per step (0 = auto: the largest M <= 2*pipe dividing the batch evenly "
                        "over the data axis)")
    p.add_argument("--zero1", action="store_true",
                   help="ZeRO-1: slice the AdamW moments and the EMA over the data-parallel ranks (the update is "
                        "unchanged)")
    p.add_argument("--pretrained", type=str, default="",
                   help="path to a torch (.pth, .pth.tar) or augreg (.npz) float checkpoint to import into the QAT "
                        "model (pass --calib-batches too: imported ranges start at zero)")
    p.add_argument("--profile-steps", type=int, default=0,
                   help="capture a torch.profiler trace of steps [10, 10+N) of epoch 0 into <output-dir>/profile; "
                        "it holds each step's train.forward, train.backward and train.optimizer spans")
    p.add_argument("--max-steps-per-epoch", type=int, default=0, help="truncate each epoch after N steps (smoke tests)")
    p.add_argument("--eval", action="store_true", help="evaluate only (with --resume or --pretrained); no training")
    p.add_argument("--dump-logits", default="",
                   help="with --eval: save per-image simulator logits + labels to this .npz (val order is "
                        "sequential, so the file aligns image for image with evaluate_accuracy --dump-logits)")
    p.add_argument("--calib-batches", type=int, default=0,
                   help="before eval/training, run N train batches with EMA range updates to calibrate "
                        "activation scales")
    p.add_argument("--fast-matmul", action="store_true",
                   help="the exact dots' backward GEMMs on bf16-rounded operands summed in float32; the forward "
                        "stays integer-exact")
    p.add_argument("--window-size", type=int, default=7,
                   help="Swin window size (every stage resolution must divide by it)")
    p.add_argument("--softmax-bits", type=int, default=16, choices=(8, 16),
                   help="ViT attention-probability precision: 16 = the reference's QAT spec; 8 = the precision "
                        "its deployed graph runs")
    p.add_argument("--gelu-stable", action="store_true",
                   help="elementwise-stable ShiftGELU (recorded in the artifact so deploy runs the same "
                        "formulation)")
    p.add_argument("--distributed", action="store_true",
                   help="data-parallel over torchrun's ranks (torch.distributed.init_process_group from its "
                        "environment); --batch-size is the global batch")
    p.add_argument("--device", default="cuda", help="cuda (the card; raises without one) or cpu")
    return p


def check_resume_spec(extra: dict, ckpt_meta: dict, model_name: str):
    """The spec guard ``convert_model`` applies, at --resume/--eval time:
    a checkpoint trained under one spec (softmax_bits, gelu_stable,
    geometry) resumed into a model built under another loads without
    error but is silently value-wrong, so raise and say which flags to
    pass. Checkpoints without the record skip the check; a Swin
    checkpoint's recorded softmax_bits 16 is the legacy record of the
    ignored ViT flag."""
    for key, built in ckpt_meta.items():
        recorded = extra.get(key)
        if key == "softmax_bits" and recorded == 16 and model_name.startswith("swin"):
            continue
        if recorded is not None and recorded != built:
            raise SystemExit(
                f"--resume checkpoint was trained with {key}="
                f"{recorded!r} but this run builds the model with "
                f"{key}={built!r}. Pass the matching flags (the "
                f"checkpoint records: "
                + ", ".join(f"{k}={extra[k]!r}" for k in ckpt_meta if extra.get(k) is not None)
                + ")."
            )


def refuse_unported(args) -> None:
    """Exit with a message for a flag whose port has not landed, or a
    ``--pretrained`` this CLI does not take."""
    if args.pretrained == "auto":
        from .models.import_torch import NO_DOWNLOAD

        raise SystemExit(NO_DOWNLOAD)
    if args.pretrained and args.model.endswith("_fp32"):
        raise SystemExit(f"--pretrained with {args.model}: the importers give the QAT model's nested tree, which a "
                         "float model's flat names do not match, so JAX's CLI keeps all but cls_token and "
                         "pos_embed at their random init (ROADMAP.md §3 item 9). Load a float model by the library "
                         "path: torch_vit_to_params (or torch_swin_to_params) -> quant_params_to_float (or "
                         "swin_quant_params_to_float) -> merge_params -> nn.load_flax_variables")


def pipe_layout(args, world: int) -> tuple:
    """``--pipe``'s ``(data, n_micro)`` on a world of ``world`` ranks, or
    exit: JAX's four guards first, in its order and words (a Swin, the
    other mesh flags, the depth, the range source), then a world the
    stages do not divide, then the microbatch count."""
    from .models.registry import create_config

    if args.model.startswith("swin"):
        raise SystemExit("--pipe supports the ViT family only: the Swin trunk is stage-heterogeneous (resolutions "
                         "halve and dims double at each PatchMerging), so its blocks do not stack into one "
                         "shardable depth axis")
    if args.mesh_model > 1 or args.seq_parallel or args.zero1:
        raise SystemExit("--pipe is exclusive with --mesh-model/--seq-parallel/--zero1: the pipeline manages its "
                         "own (data, pipe) mesh")
    depth = create_config(args.model.removesuffix("_fp32"))["depth"]
    if depth % args.pipe:
        raise SystemExit(f"--pipe {args.pipe} does not divide {args.model}'s depth {depth}")
    if not args.eval and not (args.resume or args.calib_batches > 0):
        raise SystemExit("--pipe runs frozen-range finetune semantics (EMA range updates are sequential-batch "
                         "semantics; see parallel/pipeline.py): populate activation ranges first with "
                         "--calib-batches N or --resume a trained checkpoint")
    if args.model.endswith("_fp32"):
        raise SystemExit(f"--pipe runs the QAT ViT family (its stages run the QAT model's prologue, blocks and "
                         f"epilogue); {args.model} is a float model")
    if world % args.pipe:
        raise SystemExit(f"--pipe {args.pipe} does not divide the {world}-rank world (WORLD_SIZE; launch with "
                         "--distributed under torchrun)")
    data, B, n_micro = world // args.pipe, args.batch_size, args.pipe_microbatches
    if n_micro == 0:
        for cand in range(min(2 * args.pipe, B), 0, -1):
            if B % cand == 0 and (B // cand) % data == 0:
                n_micro = cand
                break
    if n_micro == 0 or B % n_micro or (B // n_micro) % data:
        raise SystemExit(f"no valid microbatch count: batch {B} must split into M microbatches of a multiple of "
                         f"data={data} rows (got --pipe-microbatches {args.pipe_microbatches})")
    return data, n_micro


def step_generators(seed: int, epoch: int, step: int, device):
    """The random sources of one train step, from (seed, epoch, step): a
    numpy generator for the mixup/cutmix draws and a torch generator on
    ``device`` for drop-path."""
    import numpy as np
    import torch

    mix = np.random.default_rng((seed, epoch, step, 0))
    drop_seed = int(np.random.default_rng((seed, epoch, step, 1)).integers(2**62))
    return mix, torch.Generator(device=device).manual_seed(drop_seed)


def main(argv=None):
    args = build_parser().parse_args(argv)
    # The reference forces min_lr = lr/15.
    args.min_lr = args.lr / 15.0
    refuse_unported(args)

    from .nn import quant

    joined = None
    if args.distributed:
        import torch.distributed as dist

        from .parallel import init_distributed

        try:
            joined = init_distributed(device=args.device)
        except RuntimeError as e:
            raise SystemExit(f"--distributed: {e}") from None
    # --fast-matmul holds for this run only: an in-process caller's later
    # runs and backward passes see the switch as it was
    prev_fast = quant.SIM_FAST_MATMUL
    quant.SIM_FAST_MATMUL = args.fast_matmul
    try:
        return _run(args, joined)
    finally:
        quant.SIM_FAST_MATMUL = prev_fast
        if joined is not None:
            dist.destroy_process_group()


def _run(args, joined=None):
    import numpy as np
    import torch

    from .core.device import target_device
    from .data import build_dataloaders, build_dataset
    from .models import create_model
    from .models.model_utils import model_variables
    from .nn.quant import data_shard
    from .parallel import batch_shard, gather_train_state, make_mesh, make_pp_mesh, shard_train_state
    from .parallel import tensor_parallel
    from .train import SGD, AdamW, MixupConfig, cosine_schedule, create_train_state, make_eval_step
    from .train import make_train_step, mixup_cutmix
    from .train.augment import one_hot_smooth
    from .utils import AverageMeter, MetricLogger, load_checkpoint, save_checkpoint

    device = target_device(args.device if joined is None else joined.device)
    # the (data, model) mesh of the run: torchrun's world, or one rank;
    # under --pipe the (data, pipe) mesh
    mesh = None
    if args.pipe > 1:
        pp_data, n_micro = pipe_layout(args, 1 if joined is None else joined.world_size)
        mesh = make_pp_mesh(pp_data, args.pipe, device=device)
    elif joined is not None or args.zero1 or args.mesh_model > 1:
        try:
            mesh = make_mesh(model=args.mesh_model, device=device)
        except ValueError as e:  # as JAX's make_mesh raises
            raise SystemExit(f"--mesh-model {args.mesh_model} does not divide the world: {e}") from None
    world = 1 if mesh is None else mesh.shape["data"]
    lead = mesh is None or mesh.rank == 0  # the rank that logs and writes
    if args.batch_size % world:
        raise SystemExit(f"--batch-size {args.batch_size} (the global batch) is not a multiple of the "
                         f"{world} ranks (WORLD_SIZE)")
    os.makedirs(args.output_dir, exist_ok=True)
    handlers = [logging.StreamHandler(), logging.FileHandler(os.path.join(args.output_dir, "log.log"))] if lead else \
        [logging.NullHandler()]
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s", handlers=handlers, force=True)
    logging.info(str(args))
    if joined is not None:
        logging.info("distributed: %d ranks over %s, rank 0 on %s; a (data=%d, %s=%d) mesh%s",
                     joined.world_size, joined.backend, device, world, mesh.axis, mesh.shape[mesh.axis],
                     ", ZeRO-1" if args.zero1 else "")
    seq_parallel = args.seq_parallel
    if seq_parallel and (args.mesh_model == 1 or args.model.startswith("swin") or args.model.endswith("_fp32")):
        logging.warning("--seq-parallel ignored (needs --mesh-model > 1 and a ViT-family model)")
        seq_parallel = False
    np.random.seed(args.seed)

    ds_train = build_dataset(args.data_set, args.data, True, args.input_size, args.nb_classes)
    ds_val = build_dataset(args.data_set, args.data, False, args.input_size, args.nb_classes)
    train_loader, val_loader = build_dataloaders(args, ds_train, ds_val)

    model_kwargs = dict(num_classes=args.nb_classes, img_size=args.input_size, drop_rate=args.drop,
                        drop_path_rate=args.drop_path)
    if args.model.startswith("swin"):
        model_kwargs["window_size"] = args.window_size
    elif args.softmax_bits != 16:
        model_kwargs["softmax_bits"] = args.softmax_bits
    if args.gelu_stable:
        model_kwargs["gelu_stable"] = True
    model = create_model(args.model, device, seed=args.seed, **model_kwargs)
    # Recorded in every checkpoint so convert_model rebuilds the exact
    # model the scales were trained for; a Swin's probabilities are 8-bit
    # by spec, so its record says 8 whatever the (ViT) flag says. A float
    # model has neither property.
    ckpt_meta = {"model": args.model, "input_size": args.input_size, "nb_classes": args.nb_classes}
    if not args.model.endswith("_fp32"):
        ckpt_meta["softmax_bits"] = 8 if args.model.startswith("swin") else args.softmax_bits
        ckpt_meta["gelu_stable"] = bool(args.gelu_stable)
    if args.model.startswith("swin"):
        ckpt_meta["window_size"] = args.window_size

    steps_per_epoch = max(1, len(train_loader))
    sched = cosine_schedule(args.lr, steps_per_epoch, args.epochs, warmup_epochs=args.warmup_epochs,
                            warmup_lr=args.warmup_lr, min_lr=args.min_lr)
    betas = tuple(args.opt_betas) if args.opt_betas else (0.9, 0.999)
    if args.opt == "adamw":
        tx = AdamW(sched, b1=betas[0], b2=betas[1], eps=args.opt_eps, weight_decay=args.weight_decay)
    elif args.opt == "sgd":
        tx = SGD(sched, momentum=args.momentum, weight_decay=args.weight_decay)
    else:
        raise ValueError(f"unknown optimizer {args.opt!r}")
    ema_decay = args.model_ema_decay if args.model_ema else 0.0
    state = create_train_state(model, tx, ema_decay=ema_decay, device=device)

    if args.pretrained:
        # into the live parameters, after the state is built, as JAX's CLI
        # does: an EMA copy keeps the initial weights
        from .models.import_torch import load_pretrained

        load_pretrained(args.pretrained, args.model, state.model)
        logging.info("imported pretrained weights from %s", args.pretrained)

    start_epoch, best_acc1 = args.start_epoch, args.best_acc1
    if args.resume:
        state, extra = load_checkpoint(args.resume, state)
        check_resume_spec(extra, ckpt_meta, args.model)
        start_epoch = extra.get("epoch", 0) + 1
        best_acc1 = extra.get("best_acc1", 0.0)
        logging.info("resumed from %s at epoch %d", args.resume, start_epoch)
    if mesh is not None and mesh.shape.get("model", 1) > 1:
        try:
            tensor_parallel(state, mesh, seq_parallel=seq_parallel)
        except (TypeError, ValueError) as e:
            raise SystemExit(f"--mesh-model {args.mesh_model}: {e}") from None
        logging.info("tensor parallelism: %s over the %d-way model axis%s", args.model, args.mesh_model,
                     ", sequence parallel" if seq_parallel else "")
    if args.zero1:
        state = shard_train_state(state, mesh)

    def save(path, extra):
        # every rank joins the gather (both axes); rank 0 writes the whole state
        whole = gather_train_state(state)
        if lead:
            save_checkpoint(path, whole, extra)

    train_step = make_train_step(model, ema_decay=ema_decay, grad_clip=args.clip_grad, mesh=mesh)
    dump_logits = bool(args.dump_logits) and args.eval
    eval_step = make_eval_step(model, return_logits=dump_logits, mesh=mesh)
    mix_cfg = MixupConfig(mixup_alpha=args.mixup, cutmix_alpha=args.cutmix, switch_prob=args.mixup_switch_prob,
                          label_smoothing=args.smoothing, num_classes=args.nb_classes)

    def validate(epoch):
        variables = model_variables(state.model)  # the live weights, as the JAX CLI validates
        acc1, acc5 = AverageMeter("acc1"), AverageMeter("acc5")
        dumped_logits, dumped_labels = [], []
        for images, labels in val_loader:
            n = images.shape[0]
            pad = -n % world
            if pad:
                # modular indexing, as JAX's CLI: pad can exceed n; the
                # step weighs the duplicates out by n
                idx = np.arange(pad) % n
                images, labels = np.concatenate([images, images[idx]]), np.concatenate([labels, labels[idx]])
            out = eval_step(variables, torch.from_numpy(images).to(device), torch.from_numpy(labels).to(device), n)
            if dump_logits:
                m, batch_logits = out
                dumped_logits.append(batch_logits[:n].cpu().numpy())
                dumped_labels.append(labels[:n])
            else:
                m = out
            acc1.update(float(m["acc1"]), n)
            acc5.update(float(m["acc5"]), n)
        if dump_logits and lead:
            np.savez(args.dump_logits, logits=np.concatenate(dumped_logits), labels=np.concatenate(dumped_labels))
            logging.info("dumped %d val logits to %s", sum(len(a) for a in dumped_labels), args.dump_logits)
        logging.info("epoch %d  val acc@1 %.3f  acc@5 %.3f", epoch, acc1.avg, acc5.avg)
        return acc1.avg

    if args.calib_batches > 0:
        # range calibration: train-mode forwards (EMA range updates), no
        # optimizer step
        train_loader.set_epoch(0)
        gen = torch.Generator(device=device).manual_seed(0)
        n_cal = 0
        with torch.no_grad(), data_shard(None if mesh is None else batch_shard(mesh)):
            for i, (images, _) in enumerate(train_loader):
                if i >= args.calib_batches:
                    break
                images = torch.from_numpy(images if mesh is None else mesh.block(images, "data"))
                state.model(images.to(device), train=True, generator=gen)
                n_cal += 1
        if n_cal == 0:
            raise RuntimeError("calibration saw ZERO batches — the train loader is empty (dataset smaller "
                               "than one batch, or a loader failure)")
        logging.info("calibrated EMA ranges over %d batches", n_cal)

    if args.eval:
        return validate(start_epoch)

    # the step, the validation and what the checkpoints record: GPipe's
    # under --pipe, the standard ones otherwise
    step, full_batch = train_step, 0
    if args.pipe > 1:
        step, validate, pipe_meta = _pipe_loop_parts(args, state, mesh, n_micro, val_loader)
        ckpt_meta, full_batch = {**ckpt_meta, **pipe_meta}, args.batch_size

    # graceful preemption: on SIGTERM let the step finish, write the
    # rolling checkpoint and exit, so --resume restarts the epoch
    preempt_sig: list = []

    def _on_preempt(signum, frame):
        preempt_sig.append(signum)

    try:
        prev_term = signal.signal(signal.SIGTERM, _on_preempt)
    except ValueError:  # not the main thread (in-process callers)
        prev_term = None
    ckpt_path = os.path.join(args.output_dir, "checkpoint.pkl")
    profile_dir = os.path.join(args.output_dir, "profile")
    use_mixup = args.mixup > 0 or args.cutmix > 0
    profiler = None
    try:
        for epoch in range(start_epoch, args.epochs):
            train_loader.set_epoch(epoch)
            logger = MetricLogger(len(train_loader), prefix=f"epoch {epoch} ", print_freq=args.print_freq)
            t0 = time.time()
            losses = []
            for i, (images, labels) in enumerate(train_loader):
                if args.max_steps_per_epoch and i >= args.max_steps_per_epoch:
                    break
                if full_batch and images.shape[0] != full_batch:
                    continue  # GPipe needs the full batch
                if args.profile_steps and epoch == 0 and i == 10:
                    profiler = _start_profile(device)
                if profiler is not None and epoch == 0 and i == 10 + args.profile_steps:
                    _stop_profile(profiler, profile_dir)
                    profiler = None
                mix_rng, drop_gen = step_generators(args.seed, epoch, i, device)
                images, labels = torch.from_numpy(images).to(device), torch.from_numpy(labels).to(device)
                if use_mixup:
                    images, targets = mixup_cutmix(images, labels, mix_cfg, mix_rng, device=device)
                else:
                    targets = one_hot_smooth(labels, args.nb_classes, args.smoothing)
                state, metrics = step(state, images, targets, drop_gen)
                losses.append(float(metrics["loss"]))
                logger.update(loss=losses[-1], acc1=float(metrics["acc1"]))
                logger.log(i)
                if mesh is not None:  # a signal to any rank stops them all at this step
                    flag = torch.tensor([float(preempt_sig[0]) if preempt_sig else 0.0], device=device)
                    signum = int(mesh.all_reduce(flag, "world", op="max").item())
                    if signum and not preempt_sig:
                        preempt_sig.append(signum)
                if preempt_sig:
                    save(ckpt_path, {"epoch": epoch - 1, "best_acc1": best_acc1, "preempted_step": i, **ckpt_meta})
                    logging.info("preempted (signal %d) at epoch %d step %d — rolling checkpoint saved; rerun with "
                                 "--resume %s to restart the epoch", preempt_sig[0], epoch, i, ckpt_path)
                    return best_acc1
            if profiler is not None:
                _stop_profile(profiler, profile_dir)
                profiler = None
            if not losses:
                raise RuntimeError(f"epoch {epoch} ran ZERO steps — the train loader yielded nothing (empty dataset "
                                   "or a loader failure)" + (", or no full batch for GPipe" if full_batch else ""))
            logging.info("epoch %d done in %.1fs (%d steps)", epoch, time.time() - t0, len(losses))
            logging.info("epoch %d losses %s", epoch, losses)

            acc1 = validate(epoch)
            if acc1 > best_acc1:
                best_acc1 = acc1
                save(os.path.join(args.output_dir, "best.pkl"), {"epoch": epoch, "best_acc1": best_acc1, **ckpt_meta})
            # the rolling resume checkpoint, every epoch
            save(ckpt_path, {"epoch": epoch, "best_acc1": best_acc1, **ckpt_meta})
            logging.info("best acc@1: %.3f", best_acc1)

        return best_acc1
    finally:
        if prev_term is not None:
            signal.signal(signal.SIGTERM, prev_term)


def _pipe_loop_parts(args, state, mesh, n_micro, val_loader):
    """What the training loop runs under ``--pipe N`` (JAX's
    ``quant_train.py:535-720``): GPipe over ``mesh``'s ``(data, pipe)``
    grid, with JAX's documented subset of the standard loop (frozen
    ranges, a deterministic step, a fresh optimizer state). Puts ``state``
    in the stage layout and returns the step (same call as the standard
    one; it draws nothing from the drop generator), the pipelined
    validation (padded to ``n_micro · data`` rows) and what the
    checkpoints record besides."""
    import numpy as np
    import torch

    from .parallel import make_pp_train_step, pipeline_vit_forward, pp_gather, to_pp_state
    from .utils import AverageMeter

    logging.info("pipeline parallelism: (data=%d, pipe=%d) mesh, %d microbatches/step", mesh.shape["data"],
                 args.pipe, n_micro)
    to_pp_state(state, mesh)
    model = state.model
    state.opt_state = state.tx.init([p for _, p in model.named_parameters()])
    ema_decay = args.model_ema_decay if args.model_ema else 0.0
    pp_step = make_pp_train_step(model, mesh, n_micro, grad_clip=args.clip_grad, ema_decay=ema_decay)
    pad_mult = n_micro * mesh.shape["data"]

    def step(state, images, targets, drop_gen):
        return pp_step(state, images, targets)

    def pp_validate(epoch):
        acc1, acc5 = AverageMeter("acc1"), AverageMeter("acc5")
        for images, labels in val_loader:
            n = images.shape[0]
            pad = -n % pad_mult
            if pad:
                images = np.concatenate([images, images[np.arange(pad) % n]])
            with torch.no_grad():
                x = torch.from_numpy(images).to(mesh.device)
                logits = pp_gather(pipeline_vit_forward(model, x, mesh, n_micro), mesh, n_micro)
            order = np.argsort(logits[:n].cpu().numpy(), -1)
            labels = np.asarray(labels)
            acc1.update(100.0 * float(np.mean(order[:, -1] == labels)), n)
            acc5.update(100.0 * float(np.mean((order[:, -5:] == labels[:, None]).any(-1))), n)
        logging.info("epoch %d  val acc@1 %.3f  acc@5 %.3f", epoch, acc1.avg, acc5.avg)
        return acc1.avg

    return step, pp_validate, {"pipe": args.pipe}


def _start_profile(device):
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    profiler = profile(activities=activities)
    profiler.start()
    return profiler


def _stop_profile(profiler, profile_dir: str) -> None:
    profiler.stop()
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, "trace.json")
    profiler.export_chrome_trace(path)
    logging.info("profile trace written to %s", path)


if __name__ == "__main__":
    main()
