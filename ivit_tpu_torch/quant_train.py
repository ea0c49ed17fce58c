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

``--pretrained auto`` (a download) and ``--pretrained`` with a
``*_fp32`` name exit, each saying why; so do the multi-device flags
(``--mesh-model`` > 1, ``--seq-parallel``, ``--pipe`` > 1, ``--zero1``,
``--distributed``), naming the ``ROADMAP.md`` item that ports them.
"""

from __future__ import annotations

import argparse
import logging
import os
import signal
import time

# the ROADMAP.md §1 item that ports what this CLI refuses
_MULTI_GPU_ITEM = "ROADMAP.md §1 item 8 (multi-GPU)"


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
    # the JAX CLI's multi-device and TPU extras: refused, with the ROADMAP item
    p.add_argument("--mesh-model", type=int, default=1, help=f"tensor parallelism; > 1 comes with {_MULTI_GPU_ITEM}")
    p.add_argument("--seq-parallel", action="store_true", help=f"sequence parallelism; comes with {_MULTI_GPU_ITEM}")
    p.add_argument("--pipe", type=int, default=1, help=f"pipeline stages; > 1 comes with {_MULTI_GPU_ITEM}")
    p.add_argument("--pipe-microbatches", type=int, default=0, help="GPipe microbatches per step (with --pipe)")
    p.add_argument("--zero1", action="store_true", help=f"sharded optimizer state; comes with {_MULTI_GPU_ITEM}")
    p.add_argument("--pretrained", type=str, default="",
                   help="path to a torch (.pth, .pth.tar) or augreg (.npz) float checkpoint to import into the QAT "
                        "model (pass --calib-batches too: imported ranges start at zero)")
    p.add_argument("--profile-steps", type=int, default=0,
                   help="capture a torch.profiler trace of steps [10, 10+N) of epoch 0 into <output-dir>/profile")
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
    p.add_argument("--distributed", action="store_true", help=f"multi-host; comes with {_MULTI_GPU_ITEM}")
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
    refused = [(args.mesh_model > 1, "--mesh-model > 1", _MULTI_GPU_ITEM),
               (args.seq_parallel, "--seq-parallel", _MULTI_GPU_ITEM),
               (args.pipe > 1, "--pipe > 1", _MULTI_GPU_ITEM),
               (args.zero1, "--zero1", _MULTI_GPU_ITEM),
               (args.distributed, "--distributed", _MULTI_GPU_ITEM)]
    for on, flag, item in refused:
        if on:
            raise SystemExit(f"{flag} is not ported to ivit_tpu_torch yet: it comes with {item}; "
                             "the JAX package's quant_train.py runs it")


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

    # --fast-matmul holds for this run only: an in-process caller's later
    # runs and backward passes see the switch as it was
    prev_fast = quant.SIM_FAST_MATMUL
    quant.SIM_FAST_MATMUL = args.fast_matmul
    try:
        return _run(args)
    finally:
        quant.SIM_FAST_MATMUL = prev_fast


def _run(args):
    import numpy as np
    import torch

    from .core.device import target_device
    from .data import build_dataloaders, build_dataset
    from .models import create_model
    from .models.model_utils import model_variables
    from .train import SGD, AdamW, MixupConfig, cosine_schedule, create_train_state, make_eval_step
    from .train import make_train_step, mixup_cutmix
    from .train.augment import one_hot_smooth
    from .utils import AverageMeter, MetricLogger, load_checkpoint, save_checkpoint

    device = target_device(args.device)
    os.makedirs(args.output_dir, exist_ok=True)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(message)s",
        handlers=[logging.StreamHandler(), logging.FileHandler(os.path.join(args.output_dir, "log.log"))],
        force=True,
    )
    logging.info(str(args))
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

    train_step = make_train_step(model, ema_decay=ema_decay, grad_clip=args.clip_grad)
    dump_logits = bool(args.dump_logits) and args.eval
    eval_step = make_eval_step(model, return_logits=dump_logits)
    mix_cfg = MixupConfig(mixup_alpha=args.mixup, cutmix_alpha=args.cutmix, switch_prob=args.mixup_switch_prob,
                          label_smoothing=args.smoothing, num_classes=args.nb_classes)

    def validate(epoch):
        variables = model_variables(state.model)  # the live weights, as the JAX CLI validates
        acc1, acc5 = AverageMeter("acc1"), AverageMeter("acc5")
        dumped_logits, dumped_labels = [], []
        for images, labels in val_loader:
            n = images.shape[0]
            out = eval_step(variables, torch.from_numpy(images).to(device), torch.from_numpy(labels).to(device), n)
            if dump_logits:
                m, batch_logits = out
                dumped_logits.append(batch_logits.cpu().numpy())
                dumped_labels.append(labels)
            else:
                m = out
            acc1.update(float(m["acc1"]), n)
            acc5.update(float(m["acc5"]), n)
        if dump_logits:
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
        with torch.no_grad():
            for i, (images, _) in enumerate(train_loader):
                if i >= args.calib_batches:
                    break
                state.model(torch.from_numpy(images).to(device), train=True, generator=gen)
                n_cal += 1
        if n_cal == 0:
            raise RuntimeError("calibration saw ZERO batches — the train loader is empty (dataset smaller "
                               "than one batch, or a loader failure)")
        logging.info("calibrated EMA ranges over %d batches", n_cal)

    if args.eval:
        return validate(start_epoch)

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
                state, metrics = train_step(state, images, targets, drop_gen)
                losses.append(float(metrics["loss"]))
                logger.update(loss=losses[-1], acc1=float(metrics["acc1"]))
                logger.log(i)
                if preempt_sig:
                    save_checkpoint(ckpt_path, state, {"epoch": epoch - 1, "best_acc1": best_acc1,
                                                       "preempted_step": i, **ckpt_meta})
                    logging.info("preempted (signal %d) at epoch %d step %d — rolling checkpoint saved; rerun with "
                                 "--resume %s to restart the epoch", preempt_sig[0], epoch, i, ckpt_path)
                    return best_acc1
            if profiler is not None:
                _stop_profile(profiler, profile_dir)
                profiler = None
            if not losses:
                raise RuntimeError(f"epoch {epoch} ran ZERO steps — the train loader yielded nothing (empty dataset "
                                   "or a loader failure)")
            logging.info("epoch %d done in %.1fs (%d steps)", epoch, time.time() - t0, len(losses))
            logging.info("epoch %d losses %s", epoch, losses)

            acc1 = validate(epoch)
            if acc1 > best_acc1:
                best_acc1 = acc1
                save_checkpoint(os.path.join(args.output_dir, "best.pkl"), state,
                                {"epoch": epoch, "best_acc1": best_acc1, **ckpt_meta})
            # the rolling resume checkpoint, every epoch
            save_checkpoint(ckpt_path, state, {"epoch": epoch, "best_acc1": best_acc1, **ckpt_meta})
            logging.info("best acc@1: %.3f", best_acc1)

        return best_acc1
    finally:
        if prev_term is not None:
            signal.signal(signal.SIGTERM, prev_term)


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
