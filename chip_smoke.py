#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``ivit_tpu_torch``) on one NVIDIA GPU.

Drives the port's paths through ``deploy.engine.build_vit_infer`` at the
full width and depth of DeiT-S and through
``deploy.swin_engine.build_swin_infer`` at the full width and depth of
Swin-T, on seeded synthetic artifacts, and checks every hand-written
kernel on them; then trains DeiT-S through the QAT trainer for a few
steps and serves the frozen result by route A (phase 7), trains Swin-T
with mixup/cutmix and serves it by K7 + K3 (phase 8), runs the
trainer's entry points (``quant_train``, ``convert_model --checkpoint``,
``evaluate_accuracy``) end to end on both models (phase 9), and takes
seeded float checkpoints in the published layouts through import,
calibration, QAT, freezing and serving, beside the float models on the
imported weights (phase 10), trains ViT-L and Swin-B at batch 128
with per-block recompute and serves every path from a serialized engine
reloaded in a fresh process (phase 11), serves and trains over
``torch.distributed`` meshes on the one card (phase 12), and trains
DeiT-S and Swin-T tensor-parallel, sequence-parallel and with ZeRO-1 on a
model axis, then serves the frozen results tensor-parallel (phase 13),
and trains DeiT-S pipelined over two stages, then serves it (phase 14):

* the main path: softmax_bits=8, stable ShiftGELU, K1 attention + K3
  LayerNorm (the default kernels), and K9 for the fc1 epilogue (bias,
  requant, stable ShiftGELU, requant), which runs with any kernel on a
  stable-GELU model;
* the reference-spec path: softmax_bits=16, row-max ShiftGELU, by three
  routes: A = K2 attention + K4 fc1-GEMM-with-GELU + K3; B = K6 Shiftmax
  into the base-256 split for the exact @V + K5 GELU + K3; and the K1 + K3 route as the
  check that all three give equal logits;
* the Swin-T serving path (``synthetic_swin_artifact("swin_tiny")``,
  row-max ShiftGELU as the JAX model defaults): K7 window attention + K3
  LayerNorm (the Swin engine's default kernels).

Phases:

1. the card's name and power limit (``nvidia-smi``);
2. builds the CUDA kernels from ``ivit_tpu_torch/csrc`` with nvcc, one
   process per source, all at once, and prints the registers and spill
   stack of K1's, K2's, K3's, K4's, K5's, K6's and K7's kernels and the
   tensor-core (IMMA) instructions of K4's and K7's (``cuobjdump``);
3. every kernel against its plain torch version, bit for bit
   (tolerance 0), at its path's batch-128 and batch-1 shapes, on the
   engine's own block-0 inputs and on random inputs that spread its
   values: K3 (25216, 384) / (197, 384); K1 and K2 (768, 197, 64) /
   (6, 197, 64) at out_bits 8 and 16, also on edge inputs (cells of equal
   scores, cells whose every score clips at -128 or +127 against
   V = -128, and a power-of-two 1/scale), one-token rows at a
   power-of-two 1/scale (probabilities 128 and 32768) at G = 768 and 6,
   and N in ATTN_N x hd in ATTN_HD on the edge inputs; K4 (25216, 384) x
   (384, 1536) / (197, ...), also on edge rows (all negative, tied at
   their max) and at a ragged (25211, 384) x (384, 1496), and its GELU
   tables on the card against their torch twin; K5 (25216, 1536) /
   (197, 1536), also on edge rows (all negative, at the int8 clip edges,
   tied at their max) at (25216, 1536), (33, 256), (5, 100) and (100,
   2048); K9 (25216, 1536) / (197, 1536) on the main path's block-0 fc1
   accumulators (also against the plain chain) and on random ones, and on
   edge inputs (|x + b| above 2^24, a wrapping bias add, rows clipping at
   both ends) at those shapes, (25211, 1536), (37, 1540) and (5, 99) from
   aligned and offset bases, and the 12 tables the engine filled on the
   card against the CPU's; K6 (151296, 197) / (1182, 197), also as a row-slice view
   (151295, 197) whose base lies 4 bytes past a 16-byte boundary, and on
   edge rows (uniform, all at -128, one-hot at 2^30) at N in K6_N with
   n_valid below and at N, M = 7 and 1182, out_bits 8 and 16, a spread
   scale and a power-of-two 1/scale (one-token rows: sm = 2^15, hi
   saturates to 127), from 16-byte aligned and offset bases; K7 at each
   Swin-T stage's (B·nW·H, 49, 32) shape, unshifted (block 0) and shifted with the window
   mask (block 1, stages 1-3), on the Swin path's own inputs and on random
   spread ones, and at every stage on edge inputs, unmasked, masked at a
   Swin-like scale and masked at a scale where masked arguments lie above
   the shift-exp clamp and masked scores are row maxima; K3 at Swin-T's
   norm inputs, (401408, 96) to (6272, 1536) and their batch-1 rows, and
   on edge rows (zero variance, alternating 32767 and -32768, values in
   +-60) at every path width with 16-byte and with scalar loads, and at
   the ragged and split-statistics widths 100, 33, 1000, 1001 and 8192;
   the engines on GEMM widths that are not multiples of 8 (a 100-class
   DeiT head, Swin at patch 2), on the card against the CPU;
4. each path at batch 128 and batch 1, with every launch count set to 0
   just before it and read just after: logits bit-equal to the plain ops
   on the card, to the plain engine on the CPU (first two images), batch
   1 equal to row 0 of batch 128, and the launches per forward stated
   (12 K1 + 25 K3 + 12 K9; A: 12 K2 + 12 K4 + 25 K3; B: 12 K6 + 12 K5 + 25 K3;
   Swin-T: 12 K7 + 28 K3); at sm16, routes A, B and K1 give equal logits;
   the nonzero share of the 8-bit attention probabilities per block;
5. times (CUDA events after warm-up): each path's images/s at batch 128
   and ms/image at batch 1; each kernel (``ms``, launched as a caller
   launches it, and ``queued_ms``, its calls queued behind a spin kernel
   so that they run back to back) beside its plain version and, for
   K4, ``torch._int_mm`` on the same GEMM (a partial yardstick the port
   never calls); each kernel's bound (the larger of its bytes over the
   HBM rate and its operations over the peak rates; K1 and K2 count
   the per-score work of their shift-exp table, ATTN_TABLE_OPS, and K7,
   K4, K5 and K6 that of their tables, WINDOW_TABLE_OPS, GELU_TABLE_OPS,
   K5_TABLE_OPS and K6_TABLE_OPS, beside the counts of the chains they
   replace); K3
   summed over one batch-128 DeiT-S and Swin-T forward beside its summed
   bounds, and as the profiler reads it in those forwards; device
   time by kernel and the device's idle share over one profiled forward
   (torch.profiler): the main path, routes A and B and Swin-T at batch
   128, and route A at batch 1;
6. the serving entry points: each of the six paths of ``deploy.graphs``
   (main, A, B, the sm16 K1 route, Swin-T and ``kernels=()``) captured as
   a CUDA graph at batch 128 and 1, with every launch count set to 0
   just before the capture and read just after (the warm-up forwards and
   both captures, the plain and the marked; ``replay.launches`` the plain
   capture's alone, one forward's),
   replay logits bit-equal to the eager ones of phase 4, a replay adding
   no launch; batch-128 images/s graphed; batch-1 ms/image eager and
   graphed (host clock) and the idle share of one batch-1 forward each
   way; no host synchronisation inside one eager forward of each path;
   the benchmark's FP32 leg on the card with TF32 off against the CPU at
   batch 2 (FP32_RTOL; TF32 on must miss it), ``strict_dyadic`` at full
   DeiT-S width bit-equal to the CPU, a reference-style DeiT-S checkpoint
   through ``convert_model`` then the default kernels on the card
   bit-equal to the plain engine on the CPU (12 K1 + 25 K3 + 12 K9); and
   ``python -m ivit_tpu_torch.bench`` (one JSON line with ``bench.py``'s
   keys) and ``python -m ivit_tpu_torch.evaluate_latency`` at batch 1
   (the main path, and ``--model swin_tiny``) run as a user runs them,
   each required to exit 0, their lines printed and their launches a
   forward checked; ViT-L/16 at 384² (577 tokens, ``vit_long_path``) by
   its default kernels at batch VIT_L384_BATCH, eager and captured, every
   count set to 0 just before each: 24 K10 + 49 K3 + 24 K9 a forward and
   no K1, the logits bit-equal to ``kernels=()`` on the card, the replay
   to the eager forward, and its images/s graphed;
7. the QAT trainer (``models.create_model``, ``train.create_train_state``,
   ``train.make_train_step``, ``deploy.convert.freeze_vit``) at the full
   width and depth of DeiT-S, on seeded normal images with label-smoothed
   one-hot targets: one train-mode step at batch 2 with drop-path 0 on
   the card and on the CPU from the same seed, the logits, the loss and
   every updated range bit-equal and every parameter gradient within
   QAT_GRAD_RTOL of its leaf's largest entry (the largest error printed);
   then a warm-up step and TRAIN_STEPS timed steps at TRAIN_BATCH with
   quant_train.py's defaults (drop-path 0.1, AdamW with weight decay 1e-4
   on every parameter, the cosine schedule with its lr/15 floor, the EMA
   of the weights), every loss finite and every range set (min < max),
   printing ms/step and images/s (CUDA events), ``max_memory_allocated``,
   the host synchronisations inside one step (as phase 6 counts them)
   and, over that profiled step, device time by kernel and the idle
   share; then ``freeze_vit`` of the EMA weights, served by route A at
   batch 128: exactly 12 K2 + 12 K4 + 25 K3 launches, rows 0-1 bit-equal
   to the plain engine on the CPU, and within three steps of the head's
   output scale of the SIM eval forward on the card, argmax equal;
8. the QAT trainer at the full width and depth of Swin-T (row-max
   ShiftGELU, the JAX model's default) with mixup/cutmix
   (``train.mixup_cutmix``, quant_train.py's defaults: mixup 0.8, cutmix
   1.0, switch prob 0.5, label smoothing 0.1): one train-mode step at
   batch 2 with drop-path 0 and smoothed one-hot targets on the card and
   on the CPU from the same seed, the logits, the loss and every updated
   range bit-equal, every parameter gradient within QAT_GRAD_RTOL of its
   leaf's largest entry and every block's relative-position bias table
   with a nonzero gradient; the mixup/cutmix arithmetic on the card and
   the CPU from the same draws, once on each branch, bit-equal; a
   warm-up step and TRAIN_STEPS timed steps at TRAIN_BATCH with
   drop-path 0.1, mixup/cutmix targets drawn each step, AdamW and the
   EMA, reported as phase 7's are; then ``deploy.swin_engine.freeze_swin``
   of the EMA weights, served by ``build_swin_infer`` with its default
   kernels at batch 128: exactly 12 K7 + 28 K3 launches, rows 0-1
   bit-equal to the plain engine on the CPU, within 4 × the head's
   output scale of the SIM eval forward on the card (the engine
   pre-rounds the bias where SIM merges it), argmax equal on every row
   whose top two SIM logits lie more than 8 head scales apart; and K7
   against its plain version (tolerance 0) on the trained model's first
   shifted block's own inputs;
9. the trainer's entry points as a user runs them, on the synthetic set
   at 224 with the Pillow-free flags (``--aa none --color-jitter 0``):
   ``ops.intmm.int8_matmul`` exact at every GEMM width of the registry's
   models at the CLIs' row counts; whether Pillow imports; the train
   loader's images/s on this host; ``quant_train`` at DeiT-S (batch 64,
   4 steps an epoch, sm16 with the row-max GELU and mixup/cutmix, the
   CLI's defaults), in process: a two-epoch run killed before the first
   step of epoch 1 (it wrote ``checkpoint.pkl`` and ``best.pkl``) and
   resumed, and two uninterrupted two-epoch runs, the resumed run's
   epoch-1 losses and parameters no further from the first uninterrupted
   run than the two uninterrupted runs are from each other (both gaps
   printed); the CLI's ms per step beside phase 7's library step, and the
   device's idle share over two profiled CLI steps; ``--eval --resume
   --dump-logits``, ``convert_model --checkpoint`` (every flag from the
   record) and ``evaluate_accuracy --batch-size 128 --dump-logits`` on
   the captured K1 + K3 engine (launches a forward 12 K1 + 25 K3), the
   engine's logits against the SIM dump (the same labels in the same
   order, within CLI_HEAD_SCALES head output scales, argmax equal on rows
   whose top two SIM logits lie more than CLI_CLEAR_SCALES head scales
   apart), K1 and K3 against their plain versions on the trained
   artifact's block-0 inputs and the kernel engine's logits equal to the
   plain engine's; then Swin-T (batch 32, 2 steps, trained through
   ``python -m ivit_tpu_torch.quant_train``), its SIM dump, conversion and
   ``python -m ivit_tpu_torch.evaluate_accuracy --max-batches 1`` on K7 +
   K3 (12 K7 + 28 K3 a forward), with the same checks and K7 and K3 on
   the trained artifact's stage-1 inputs;
10. pretrained import, at the full width and depth of DeiT-S and Swin-T
   with TF32 off: a seeded state dict in DeiT-S's published ``.pth``
   layout (``{"model": sd}``, its position embedding on a 24 x 24 grid,
   577 tokens) and one in Swin-T's (with the release's
   ``relative_position_index`` and ``attn_mask`` buffers), each
   imported by ``models.import_torch.load_pretrained`` into the QAT
   model on the card (every parameter leaf equal to the importer's tree
   on the CPU, the 577 -> 197 resize among them, and within float32
   rounding of ``F.interpolate``'s bicubic on the card; the import's
   host ms); the float model (``deit_small_fp32``, ``swin_tiny_fp32``)
   on the same weights by the library path (``quant_params_to_float``
   -> ``merge_params`` -> ``load_flax_variables``) at batch 128: ms a
   forward, logits within FLOAT_TOL of the CPU's; the SIM model
   calibrated on the import against it (correlation above
   SIM_FLOAT_CORR); for DeiT-S one ``--fast-matmul`` train-mode step
   against the float32 step on the same batch (logits and loss
   bit-equal, gradients within FAST_GRAD_RTOL) and both train steps
   timed in turns; then ``quant_train --pretrained --calib-batches 2``
   (two steps; Swin-T at batch 32), ``convert_model --checkpoint`` and
   ``evaluate_accuracy`` on the captured engine (12 K1 + 25 K3 and 12 K7
   + 28 K3 a forward, the launch counts set to 0 just before and read
   just after), the engine against the SIM dump as in phase 9, and K1,
   K3 and K7 against their plain versions on the fine-tuned artifacts'
   own inputs; ``quant_train --model deit_small_fp32`` two steps; and a
   seeded augreg ViT-B ``.npz`` imported into ``vit_base`` (every leaf
   equal, the import's host ms);
11. the recompute and the serialized engines: (a) ViT-L and Swin-B at
   full width and depth with ``remat``: one train-mode step at batch 4,
   drop-path 0.1 from a seeded generator, with and without the
   recompute from the same weights (logits, every range and the
   generator's final state bit-equal, every gradient within
   QAT_GRAD_RTOL of its leaf's largest entry), then steps with AdamW
   and the EMA timed both ways at the largest batch that fits without it
   (32 and 64 by ``scripts/torch_train_memory.py``) and with it at 128,
   each with its ms a step and ``max_memory_allocated``; (b) the DeiT-S
   main path, routes A and B, ``strict_dyadic`` and Swin-T exported by
   ``deploy.export_engine`` at batch 128 and 1 in EXPORT_WORKERS spawned
   processes, each building its path's engine as this process does
   (``path_engine``; each file's size and export time), then all
   reloaded in one fresh process that builds no engine
   (``scripts/torch_reload_engine.py``): logits bit-equal to the live
   engine's and the launches a forward, every count set to 0 just
   before it and read just after, those of phase 4 (none in strict
   mode); (c) each but strict mode's reloaded in this process, eager
   and captured by ``capture_infer`` beside the live engine in turns
   (live, reloaded, reloaded, live): images/s at 128 (CUDA events) and
   ms at batch 1 (host clock), the captured launches and the replay
   bit-equal; (d) the host µs a call of each wrapper K1-K7 takes at
   its batch-128 shape, through its ``ivit::`` operator (``host_us``);
12. multi-GPU on the one card: (a) a world of one over nccl, launched by
   ``python -m torch.distributed.run --standalone --nproc-per-node 1``:
   ``quant_train --distributed --zero1`` (DeiT-S, two steps at batch 32)
   whose checkpoint equals the same run's without ``--distributed`` leaf
   for leaf, then ``evaluate_accuracy --mesh-data 1`` on the converted
   result, its logits equal to the single-process sweep's and 12 K1 + 25
   K3 a captured forward; (b) MESH_RANKS spawned ranks sharing cuda:0
   over a gloo group named explicitly (the tensors and kernels on the
   card, each collective staged through the host; no figure of this
   phase is a scaling figure): the DeiT-S main path data-parallel at
   batch 128 and tensor-parallel at 128 and 1, route B and Swin-T
   tensor-parallel at 128, every rank's logits bit-equal to phase 4's
   single-process engine and its launches a forward read around its own
   run (12 K1 + 25 K3 + 12 K9; 12 K6 + 12 K5 + 25 K3; 12 K7 + 28 K3), K4 under a
   model axis raising; K1, K3, K5, K6 and K7 (each Swin-T stage's first
   block, stage 1 replicated) against their plain versions on each
   rank's own inputs (tolerance 0; timed on rank 0 with its bound, the
   ``tp2`` entries of the kernels line); and DeiT-S QAT at a global batch
   of MESH_QAT_BATCH (drop path 0.1, mixup/cutmix) for MESH_QAT_STEPS
   steps, data-parallel and with ZeRO-1, against the single-process step
   on the card: every range and logit bit-equal, the loss and the
   parameters within the bounds of ``tests/test_torch_parallel_train.py``,
   ZeRO-1 equal to DP bit for bit, and each rank's optimizer-state bytes
   both ways;
13. tensor-parallel QAT on the one card (``parallel.tensor_parallel``),
   ranks sharing cuda:0 over gloo as in phase 12 (no figure a scaling
   figure): DeiT-S at sm8 with the stable GELU and at sm16 with the
   row-max GELU, depth 12, on a (1, 2) mesh, tensor-parallel and
   sequence-parallel (197 tokens as 99 and 98), and Swin-T at TP=2 (its
   3-head stage 1 whole), each TPQ_STEPS steps at a global batch of
   TPQ_BATCH (drop path 0.1, mixup/cutmix), then DeiT-S sm16 on a (2, 2)
   mesh of four ranks, tensor-parallel, with ZeRO-1 and remat, and
   sequence-parallel with both: against the single-process step on the
   card, step 1's logits and every range bit-equal, the first gradient
   within TPQ_GRAD_RTOL of each leaf's largest entry, the step-1 loss
   within MESH_LOSS_ULPS, ZeRO-1 + remat equal to the tensor-parallel
   step bit for bit; each rank's ms a step and optimizer-state bytes.
   The TP-trained DeiT-S (sm8, stable) and Swin-T are gathered whole,
   frozen and served by ``shard_infer_tp`` at TPQ_SERVE_BATCH: every
   rank's logits equal to the single-process engine's, 12 K1 + 25 K3 +
   12 K9 and 12 K7 + 28 K3 a forward, and K3, K1 and K7 (each stage) against
   their plain versions on each rank's inputs (timed on rank 0: the
   ``tp2_trained`` entries of the kernels line);
14. the GPipe pipeline on the one card (``parallel.pipeline``), two
   ranks sharing cuda:0 over gloo, a stage each: DeiT-S (sm8, stable
   GELU) at full width and depth, calibrated by one batch, on a ``(data,
   pipe) = (1, 2)`` mesh, 6 blocks a stage, a global batch of PP_BATCH
   in PP_MICRO microbatches: the pipelined frozen logits bit-equal to the
   single-process forward on the card; step 1 against the single-stage
   step (pipe = 1): the loss within MESH_LOSS_ULPS, the gradient within
   TPQ_GRAD_RTOL of each leaf's largest entry, the parameters within
   phase 12's bounds; each rank's ms a step and optimizer-state bytes,
   which must be PP_OPT_BYTES. The pipe-trained model is gathered whole,
   frozen and served by ``build_vit_infer`` at PP_SERVE_BATCH: 12 K1 +
   25 K3 + 12 K9 a forward, its logits equal to ``kernels=()``'s, K1 and K3
   against their plain versions on this model's inputs (the
   ``pipe_trained`` entries of the kernels line).

Any failed check raises and exits nonzero before the result lines. The
second-to-last line is the kernels' JSON record, the last line
``{"ok": true, "device": {...}}``. Exits nonzero without a CUDA device
or without the package beside it.

Usage: ``python3 chip_smoke.py`` from the repository root (one card).
"""

from __future__ import annotations

import ast
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 0
BATCH = 128
ROUTE_A = ("layernorm", "attention2", "linear_gelu")
ROUTE_B = ("layernorm", "softmax", "gelu")
POW2_SCALE = 0.125  # 1/scale a power of two: a one-token row's probability is 2^(out_bits-1)
ATTN_N = (1, 17, 32, 33, 197, 256)  # K1/K2 edge shapes: tokens ...
ATTN_HD = (8, 32, 64, 128)          # ... against head widths
K6_N = (1, 5, 197, 256)             # K6 edge shapes: tokens a row
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaMemcpy")  # host calls that wait on the device
# the FP32 leg on the card against the CPU: relative to the largest |logit|
# (float32 products summed in other orders; TF32 rounds every product's
# inputs to 10 mantissa bits)
FP32_RTOL = 4e-6

# phase 7, the trainer: quant_train.py's defaults (lr, warm-up lr, weight
# decay, drop-path, label smoothing, EMA decay) at batch 64, a warm-up step
# and TRAIN_STEPS timed ones
TRAIN_BATCH = 64
TRAIN_STEPS = 5
TRAIN_LR = 1e-6
TRAIN_WD = 1e-4
TRAIN_DROP_PATH = 0.1
TRAIN_SMOOTHING = 0.1
TRAIN_EMA = 0.99996
QAT_GRAD_RTOL = 1e-5  # of each leaf's largest entry (tests/test_torch_qat_model.py)
# phase 9, the trainer's entry points: the synthetic set at 224 with the
# Pillow-free flags, one log line a step; --best-acc1 -1 makes the first
# validation a new best, so the run writes best.pkl
CLI_SIZE = 224
CLI_EVAL = ["--data-set", "SYNTHETIC", "--input-size", str(CLI_SIZE), "--nb-classes", "1000"]
CLI_TRAIN = [*CLI_EVAL, "--aa", "none", "--color-jitter", "0", "--best-acc1", "-1", "--print-freq", "1"]
CLI_TRAIN_BATCH = 64
CLI_DEIT_STEPS = 4
CLI_DEIT = ["--model", "deit_small", "--batch-size", str(CLI_TRAIN_BATCH), "--max-steps-per-epoch", str(CLI_DEIT_STEPS)]
CLI_SWIN = ["--model", "swin_tiny", "--batch-size", "32", "--max-steps-per-epoch", "2"]
# phase 10, pretrained import: seeded float checkpoints in the published
# layouts, DeiT-S's with its position embedding on a PRE_GRID x PRE_GRID
# grid (577 tokens: the bicubic resize to 197 runs), Swin-T's at window
# PRE_WINDOW and an augreg .npz of PRE_NPZ; each QAT model fine-tuned
# from its import through quant_train (PRE_CALIB calibration batches,
# PRE_STEPS steps) and served
PRE_DEIT, PRE_SWIN, PRE_NPZ = "deit_small", "swin_tiny", "vit_base"
PRE_GRID = 24
PRE_WINDOW = 7
PRE_CALIB = 2
PRE_STEPS = 2
PRE_SWIN_BATCH = 32
FLOAT_ITERS = 5
# the float models' logits, card against CPU, rtol = atol: float32 sums in
# other orders and the card's own erf, exp and rsqrt
# (tests/test_torch_float_models.py holds the port to JAX at the same 1e-5)
FLOAT_TOL = 1e-5
SIM_FLOAT_CORR = 0.95  # INT8 SIM against float logits (tests/test_float_ref.py)
# --fast-matmul gradients against float32 ones, of each leaf's largest
# entry: 16 units of bf16's 2^-9 (tests/test_torch_fast_matmul.py)
FAST_GRAD_RTOL = 2.0**-5
CLI_HEAD_SCALES = 4   # the engine against SIM, in head output scales (phases 7-8)
CLI_CLEAR_SCALES = 8  # rows whose top two SIM logits lie further apart must agree in argmax

# Published H100 SXM peaks (NVIDIA's data sheet, dense): HBM bytes/ms and
# int8 tensor-core ops/ms. 67 TFLOP/s in float32 counts an FMA as two
# operations: one float32 instruction per lane and clock is 33.5 T/s, and
# the chains have no FMA (-fmad=false). An SM has half as many int32 lanes
# as float32 ones (NVIDIA's H100 architecture paper), so 16.75 T/s int32.
HBM_PER_MS = 3.35e12 / 1e3
INT8_PER_MS = 1979e12 / 1e3
F32_PER_MS = 33.5e12 / 1e3
INT32_PER_MS = 16.75e12 / 1e3
# Elementwise instructions of each chain per element, counted from the
# kernels' source as (float32, int32); each add, mul, div, floor, rint,
# min, max and conversion is one, and loop-invariant terms are left out:
REQUANT_OPS = (4, 0)     # mul, rint, max, min
SHIFT_EXP_OPS = (17, 3)  # 2 x (div, floor), add, sub, max, div, floor, mul, 3 sub, mul, floor, 2 clip; exp2i
SHIFTMAX_OPS = (REQUANT_OPS[0] + 2 + SHIFT_EXP_OPS[0] + 2, SHIFT_EXP_OPS[1] + 1)  # max, sub; mul, floor; int sum
# K1 and K2 look the shift-exp up in a 256-entry table of the integer
# z - zmax (filled once per block), so per score the least work is the
# requant, the max, the multiply and the floor (float32) and the
# subtract, the lookup and the sum (int32)
ATTN_TABLE_OPS = (REQUANT_OPS[0] + 3, 3)
SPLIT_OPS = (7, 0)       # div, floor, mul, sub, sub, 2 x saturate
GELU_OPS = (2 * REQUANT_OPS[0] + 2 + SHIFT_EXP_OPS[0] + 9, SHIFT_EXP_OPS[1])  # max, sub; add, clip 2, div, floor, mul, div, floor, mul
LAYERNORM_OPS = (10, 10)  # int32 split statistics; convert, sub, mul, div, floor, add, requant
WINDOW_MERGE_OPS = (5, 0)  # K7's bias merge: mul, rint, add, max, min
MASK_OPS = (1, 0)          # K7's shifted-window mask add
# K7 since its tensor-core redesign looks rint(a8 * rb) up in a 256-entry
# table and the shift-exp in K1's table (plus a clamp entry), so per score
# the least work is the requant, the bias add, the clip, the max, the
# subtract, the multiply and the floor (float32) and two lookups and the
# sum (int32); the mask add stays MASK_OPS
WINDOW_TABLE_OPS = (REQUANT_OPS[0] + 7, 3)
# K4 since its redesign reads the whole GELU chain from a (q, max q)
# table: per element the int -> float step and the r1 requant (float32)
# and the bias add, the row max and the lookup (int32)
GELU_TABLE_OPS = (REQUANT_OPS[0] + 1, 3)
# K5 since its redesign reads the chain from the same table: per element
# the int -> float step and the r1 requant (float32) and the row max and
# the lookup (int32)
K5_TABLE_OPS = (REQUANT_OPS[0] + 1, 2)
# K9, per element: the requant (its rint a magic-number add) in float32;
# the int32 bias add, the conversion to float32 and the table byte
K9_TABLE_OPS = (REQUANT_OPS[0], 3)
# K6 since its redesign looks the shift-exp up in K1's table of the
# integral z - zmax and splits sm in integers: per score the int -> float
# step, the requant, the u32 -> float step, the multiply and the floor
# (float32), and the max, the subtract, the lookup, the sum and the
# split's shift, min, and and xor (int32)
K6_TABLE_OPS = (REQUANT_OPS[0] + 4, 8)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def cuda_ms(fn, iters: int, warmup: int = 3, queued: bool = False) -> float:
    """Mean device milliseconds per call, CUDA events around ``iters`` calls.
    ``queued`` first holds the stream in a spin kernel of about 0.1 ms a
    call, so that the host has queued the calls before the first runs: the
    events then time the kernels back to back, not the host's launch rate
    (a kernel of a few microseconds launches slower than it runs)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(iters * 200_000)  # clock cycles: about 0.1 ms a call
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def paired_ms(kernel_fn, plain_fn, iters: int) -> tuple[float, float, float]:
    """Kernel and plain times in the order plain, kernel, kernel, plain, and
    between the two kernel readings two of the kernel queued ahead of the
    device (``cuda_ms(queued=True)``): (kernel, plain, kernel queued)."""
    p1 = cuda_ms(plain_fn, iters)
    k1 = cuda_ms(kernel_fn, iters)
    q1 = cuda_ms(kernel_fn, iters, queued=True)
    q2 = cuda_ms(kernel_fn, iters, queued=True)
    k2 = cuda_ms(kernel_fn, iters)
    p2 = cuda_ms(plain_fn, iters)
    return (k1 + k2) / 2, (p1 + p2) / 2, (q1 + q2) / 2


def bound_ms(nbytes: float, int8_ops: float = 0.0, elementwise: tuple = (0.0, 0.0)) -> tuple[float, str]:
    """The least time the card could take: the larger of the bytes over
    the HBM rate and the operations of each unit over its peak rate
    (int8 tensor cores; float32 and int32 lanes, ``elementwise`` counts).
    The units run at the same time, so the largest of these times bounds."""
    t_bytes = nbytes / HBM_PER_MS
    t_ops = max(int8_ops / INT8_PER_MS, elementwise[0] / F32_PER_MS, elementwise[1] / INT32_PER_MS)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def per_element(n: int, *chains: tuple) -> tuple:
    """(float32, int32) operation counts of ``chains`` over n elements."""
    return (n * sum(c[0] for c in chains), n * sum(c[1] for c in chains))


def max_abs_err(a, b) -> int:
    return int((a.to(dtype=b.dtype).long() - b.long()).abs().max())


def reference_vit_state(a: dict) -> dict:
    """A reference-style DeiT QAT state dict (the ``weight_integer`` /
    ``bias_integer`` / ``*_scaling_factor`` buffers the ingester reads, as
    numpy arrays) holding the integers and scales of artifact ``a``."""
    import numpy as np

    f32 = np.float32
    p, D = a["config"]["patch_size"], a["config"]["embed_dim"]
    sd = {}

    def act(name, scale):
        sd[f"{name}.act_scaling_factor"] = np.array([scale], f32)

    def linear(prefix, layer, s_in):
        sd[f"{prefix}.weight_integer"] = layer["w"].T.astype(f32)
        sd[f"{prefix}.bias_integer"] = layer["b"].astype(f32)
        sd[f"{prefix}.fc_scaling_factor"] = (layer["out_scale"] / f32(s_in)).astype(f32)

    def norm(prefix, n):
        sd[f"{prefix}.bias_integer"], sd[f"{prefix}.norm_scaling_factor"] = n["bias_int"], n["out_scale"]

    pe = a["patch_embed"]
    act("qact_input", a["input_scale"])
    sd["patch_embed.proj.weight_integer"] = pe["w"].reshape(p, p, 3, D).transpose(3, 2, 0, 1).astype(f32)
    sd["patch_embed.proj.bias_integer"] = pe["b"].astype(f32)
    sd["patch_embed.proj.conv_scaling_factor"] = (pe["out_scale"] / f32(a["input_scale"])).astype(f32)
    act("patch_embed.qact", a["embed_scale"])
    sd["cls_token"] = (a["cls_q"] * a["embed_scale"]).astype(f32)
    act("qact_pos", a["pos_scale"])
    sd["pos_embed"] = (a["pos_q"] * a["pos_scale"]).astype(f32)
    act("qact1", a["tokens_scale"])
    for i, blk in enumerate(a["blocks"]):
        b = f"blocks.{i}"
        norm(f"{b}.norm1", blk["norm1"])
        act(f"{b}.qact1", blk["s_qact1"])
        linear(f"{b}.attn.qkv", blk["qkv"], blk["s_qact1"])
        for name, key in (("attn.qact1", "s_attn_qact1"), ("attn.qact_attn1", "s_attn_sm_in"), ("attn.qact2", "s_attn_out")):
            act(f"{b}.{name}", blk[key])
        linear(f"{b}.attn.proj", blk["proj"], blk["s_attn_out"])
        act(f"{b}.attn.qact3", blk["s_attn_proj"])
        act(f"{b}.qact2", blk["s_res1"])
        norm(f"{b}.norm2", blk["norm2"])
        act(f"{b}.qact3", blk["s_qact3"])
        linear(f"{b}.mlp.fc1", blk["fc1"], blk["s_qact3"])
        act(f"{b}.mlp.qact_gelu", blk["s_gelu_in"])
        act(f"{b}.mlp.qact1", blk["s_gelu_out"])
        linear(f"{b}.mlp.fc2", blk["fc2"], blk["s_gelu_out"])
        act(f"{b}.mlp.qact2", blk["s_mlp_out"])
        act(f"{b}.qact4", blk["s_res2"])
    norm("norm", a["norm"])
    act("qact2", a["head_in_scale"])
    linear("head", a["head"], a["head_in_scale"])
    return sd


def real_scale_artifact(a: dict) -> dict:
    """``a`` with its biases, class token and position embedding at the
    real values they stand for (the integers times their scales). The FP32
    benchmark leg feeds the raw integers (its timing does not depend on
    the values), under which its logits are the head's integer bias plus
    terms below that bias's float32 spacing; at real values the leg is a
    well-conditioned forward, on which TF32 shows."""
    import copy

    import numpy as np

    a = copy.deepcopy(a)
    for layer in [a["patch_embed"], a["head"]] + [blk[k] for blk in a["blocks"] for k in ("qkv", "proj", "fc1", "fc2")]:
        layer["b"] = (layer["b"].astype(np.float32) * layer["out_scale"]).astype(np.float32)
    a["pos_q"] = (a["pos_q"] * a["pos_scale"]).astype(np.float32)
    a["cls_q"] = (a["cls_q"] * a["embed_scale"]).astype(np.float32)
    return a


def run_cli(args: list, timeout: int) -> list:
    """Run ``python -m <args>`` from the repository root as a user would;
    print its output; fail unless it exits 0. Returns its stdout lines."""
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, "-m", *args], cwd=REPO, capture_output=True, text=True, timeout=timeout)
    print(f"cli python -m {' '.join(args)}: exit {run.returncode} in {time.perf_counter() - t0:.1f} s")
    for line in run.stdout.strip().splitlines():
        print(f"  stdout: {line}")
    for line in run.stderr.strip().splitlines()[-6:]:
        print(f"  stderr: {line}")
    check(run.returncode == 0, f"python -m {' '.join(args)} exited {run.returncode}")
    return run.stdout.strip().splitlines()


def card_vs_cpu_gradients(label: str, card, host, loss_c, loss_h, t0: float) -> dict:
    """Every parameter gradient of ``loss_c`` (on the card) against that of
    ``loss_h`` (on the CPU) within QAT_GRAD_RTOL of its leaf's largest
    entry; prints the largest error. Returns the card's gradients by name."""
    import torch

    names = [n for n, _ in host.named_parameters()]
    gc = torch.autograd.grad(loss_c, list(card.parameters()), materialize_grads=True)
    gh = torch.autograd.grad(loss_h, list(host.parameters()), materialize_grads=True)
    worst, worst_name = 0.0, ""
    for name, a, b in zip(names, gc, gh):
        scale = float(b.abs().max())
        rel = float((a.cpu() - b).abs().max()) / scale if scale else float((a.cpu() - b).abs().max())
        if rel >= worst:
            worst, worst_name = rel, name
    print(f"{label} step 1: parameter gradients card vs CPU, largest error relative to its leaf's largest entry "
          f"{worst} ({worst_name}; bound {QAT_GRAD_RTOL}), in {time.perf_counter() - t0:.3f} s")
    check(worst <= QAT_GRAD_RTOL, f"{label}: gradients differ beyond {QAT_GRAD_RTOL} ({worst_name})")
    return dict(zip(names, gc))


def profile_step(label: str, fn, step_ms: float) -> None:
    """Profile one call of the train step ``fn``: print the host
    synchronisations inside it (as phase 6 counts them, beside an empty
    window's), device time by kernel and the device's idle share."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def profiled(call) -> tuple:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t1) * 1e3
        syncs = {c: sum(1 for e in prof.events() if e.device_type == DeviceType.CPU and e.name == c)
                 for c in SYNC_CALLS}
        kernels = sorted(((e.self_device_time_total / 1e3, e.count, e.key) for e in prof.key_averages()
                          if e.device_type == DeviceType.CUDA), reverse=True)
        return syncs, kernels, wall

    empty, _, _ = profiled(lambda: None)
    syncs, kernels, wall = profiled(fn)
    busy = sum(k[0] for k in kernels)
    print(f"{label}: host synchronisations in one train step {syncs} (an empty window: {empty}); "
          f"{sum(syncs.values()) - sum(empty.values())} beyond the window's own")
    print(f"{label}: profile of one batch-{TRAIN_BATCH} train step: kernel time {busy} ms in {wall} ms wall "
          f"(profiled), idle share {1 - busy / wall}; against the unprofiled {step_ms} ms/step {1 - busy / step_ms}; "
          f"{sum(k[1] for k in kernels)} kernels")
    for ms, calls, key in kernels[:10]:
        print(f"  {ms} ms ({ms / busy:.4f}) {calls} calls: {key[:150]}")


def trainer_phase(dev) -> float:
    """Phase 7: the QAT trainer on the card at DeiT-S, then its frozen
    model served by route A (module docstring). Returns the library's
    ms per train step."""
    import numpy as np
    import torch

    from ivit_tpu_torch.deploy.convert import freeze_vit
    from ivit_tpu_torch.deploy.engine import build_vit_infer
    from ivit_tpu_torch.kernels import WRAPPERS
    from ivit_tpu_torch.models import create_model
    from ivit_tpu_torch.models.model_utils import eval_variables
    from ivit_tpu_torch.train import AdamW, cosine_schedule, create_train_state, make_train_step
    from ivit_tpu_torch.train import soft_target_cross_entropy

    rng = np.random.default_rng(SEED + 7)

    def batch(n: int):
        """Seeded normal images and label-smoothed one-hot targets."""
        x = torch.from_numpy(rng.standard_normal((n, 224, 224, 3), dtype=np.float32))
        t = np.full((n, 1000), TRAIN_SMOOTHING / 1000, np.float32)
        t[np.arange(n), rng.integers(0, 1000, n)] += 1.0 - TRAIN_SMOOTHING
        return x, torch.from_numpy(t)

    # 7.1 one train-mode step at batch 2, drop-path 0: the card against the CPU
    t0 = time.perf_counter()
    card, host = create_model("deit_small", dev, seed=SEED), create_model("deit_small", "cpu", seed=SEED)
    x2, t2 = batch(2)
    lc, lh = card(x2.to(dev), train=True), host(x2, train=True)
    loss_c, loss_h = soft_target_cross_entropy(lc, t2.to(dev)), soft_target_cross_entropy(lh, t2)
    stats_equal = all(torch.equal(a.cpu(), b) for a, b in zip(card.buffers(), host.buffers()))
    print(f"trainer step 1, batch 2: logits card vs CPU max_abs_err {float((lc.detach().cpu() - lh.detach()).abs().max())}, "
          f"loss {loss_c.item()} vs {loss_h.item()}, {len(list(card.buffers()))} ranges equal {stats_equal} "
          "(tolerance 0)")
    check(torch.equal(lc.detach().cpu(), lh.detach()), "trainer: train-mode logits differ between the card and the CPU")
    check(loss_c.item() == loss_h.item(), "trainer: the loss differs between the card and the CPU")
    check(stats_equal, "trainer: the updated ranges differ between the card and the CPU")
    card_vs_cpu_gradients("trainer", card, host, loss_c, loss_h, t0)
    del card, host, lc, lh, loss_c, loss_h

    # 7.2 train steps at TRAIN_BATCH with drop-path 0.1 and the EMA
    model = create_model("deit_small", dev, seed=SEED, drop_path_rate=TRAIN_DROP_PATH)
    sched = cosine_schedule(TRAIN_LR, TRAIN_STEPS + 1, 1, warmup_epochs=0, warmup_lr=TRAIN_LR)
    state = create_train_state(model, AdamW(sched, weight_decay=TRAIN_WD), ema_decay=TRAIN_EMA, device=dev)
    step = make_train_step(model, ema_decay=TRAIN_EMA)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    batches = [tuple(a.to(dev) for a in batch(TRAIN_BATCH)) for _ in range(TRAIN_STEPS + 1)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    losses = [step(state, *batches[0], gen)[1]["loss"]]  # the warm-up step
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for x, t in batches[1:]:
        losses.append(step(state, x, t, gen)[1]["loss"])
    end.record()
    end.synchronize()
    step_ms = start.elapsed_time(end) / TRAIN_STEPS
    peak = torch.cuda.max_memory_allocated(dev)
    losses = [v.item() for v in losses]
    print(f"trainer: deit_small, batch {TRAIN_BATCH}, drop-path {TRAIN_DROP_PATH}, AdamW lr {TRAIN_LR} weight decay "
          f"{TRAIN_WD}, EMA {TRAIN_EMA}: losses {losses}; {step_ms} ms/step, {TRAIN_BATCH * 1000 / step_ms} images/s "
          f"over {TRAIN_STEPS} steps after a warm-up step (CUDA events); max_memory_allocated {peak} bytes "
          f"({peak / 2**30:.3f} GiB)")
    check(all(math.isfinite(v) for v in losses), f"trainer: a non-finite loss {losses}")
    ranges = dict(model.named_buffers())
    unset = [n for n in ranges if n.endswith("min_val") and not ranges[n] < ranges[n[:-7] + "max_val"]]
    check(not unset, f"trainer: ranges not set (min >= max): {unset}")

    profile_step("trainer", lambda: step(state, *batches[1], gen), step_ms)

    # 7.3 freeze the trained state (its EMA weights) and serve it by route A
    t0 = time.perf_counter()
    variables = eval_variables(state)
    art = freeze_vit(model, variables, device=dev)
    del batches, state, step
    torch.cuda.empty_cache()
    infer = build_vit_infer(art, dev, kernels=ROUTE_A)
    images, _ = batch(BATCH)
    for w in WRAPPERS.values():
        w.launches = 0
    logits = infer(images.to(dev))
    torch.cuda.synchronize()
    counts = {k: w.launches for k, w in WRAPPERS.items() if w.launches}
    depth = art["config"]["depth"]
    cpu2 = build_vit_infer(art, "cpu", kernels=())(images[:2])
    with torch.no_grad():
        sim = torch.func.functional_call(model, {**variables["params"], **variables["quant_stats"]},
                                         (images.to(dev),), {"train": False})
    head = float(np.max(art["head"]["out_scale"]))
    e_sim = float((logits - sim).abs().max())
    argmax_equal = torch.equal(logits.argmax(-1), sim.argmax(-1))
    print(f"trainer: frozen (EMA weights) and served by route A at batch {BATCH}: launches {counts}; rows 0-1 vs the "
          f"plain engine on the CPU max_abs_err {float((logits[:2].cpu() - cpu2).abs().max())} (tolerance 0); vs the SIM "
          f"eval forward on the card max_abs_err {e_sim} (bound 3 x head out_scale {3 * head}), argmax equal "
          f"{argmax_equal}; in {time.perf_counter() - t0:.3f} s")
    check(counts == {"K2": depth, "K4": depth, "K3": 2 * depth + 1}, f"trainer serve: launches {counts}")
    check(torch.equal(logits[:2].cpu(), cpu2), "trainer serve: route A differs from the CPU plain engine")
    check(e_sim <= 3 * head and argmax_equal, "trainer serve: route A is off the SIM eval forward")
    return step_ms


def swin_trainer_phase(dev) -> None:
    """Phase 8: the QAT trainer on the card at Swin-T with mixup/cutmix,
    then its frozen model served by K7 + K3 (module docstring)."""
    import numpy as np
    import torch

    from ivit_tpu_torch.deploy.swin_engine import build_swin_infer, freeze_swin, swin_trunk, patch_embed
    from ivit_tpu_torch.deploy.swin_engine import window_attention_inputs
    from ivit_tpu_torch.kernels import WRAPPERS, fused_int8_window_attention, fused_int8_window_attention_reference
    from ivit_tpu_torch.models import create_model
    from ivit_tpu_torch.models.model_utils import eval_variables
    from ivit_tpu_torch.train import AdamW, MixupConfig, cosine_schedule, create_train_state, make_train_step
    from ivit_tpu_torch.train import mixup_cutmix, soft_target_cross_entropy
    from ivit_tpu_torch.train.augment import apply_mixup, draw_mixup, one_hot_smooth

    rng = np.random.default_rng(SEED + 8)
    mix_cfg = MixupConfig()  # quant_train.py's defaults: 0.8, 1.0, 0.5, smoothing 0.1, 1000 classes

    def batch(n: int):
        """Seeded normal images and labels."""
        x = torch.from_numpy(rng.standard_normal((n, 224, 224, 3), dtype=np.float32))
        return x, torch.from_numpy(rng.integers(0, 1000, n))

    # 8.1 one train-mode step at batch 2, drop-path 0: the card against the CPU
    t0 = time.perf_counter()
    card = create_model("swin_tiny", dev, seed=SEED, drop_path_rate=0.0)
    host = create_model("swin_tiny", "cpu", seed=SEED, drop_path_rate=0.0)
    x2, y2 = batch(2)
    t2 = one_hot_smooth(y2, mix_cfg.num_classes, mix_cfg.label_smoothing)
    lc, lh = card(x2.to(dev), train=True), host(x2, train=True)
    loss_c, loss_h = soft_target_cross_entropy(lc, t2.to(dev)), soft_target_cross_entropy(lh, t2)
    stats_equal = all(torch.equal(a.cpu(), b) for a, b in zip(card.buffers(), host.buffers()))
    print(f"swin trainer step 1, batch 2: logits card vs CPU max_abs_err "
          f"{float((lc.detach().cpu() - lh.detach()).abs().max())}, loss {loss_c.item()} vs {loss_h.item()}, "
          f"{len(list(card.buffers()))} ranges equal {stats_equal} (tolerance 0)")
    check(torch.equal(lc.detach().cpu(), lh.detach()), "swin trainer: train-mode logits differ between the card and the CPU")
    check(loss_c.item() == loss_h.item(), "swin trainer: the loss differs between the card and the CPU")
    check(stats_equal, "swin trainer: the updated ranges differ between the card and the CPU")
    grads = card_vs_cpu_gradients("swin trainer", card, host, loss_c, loss_h, t0)
    tables = {n: float(g.abs().max()) for n, g in grads.items() if n.endswith("relative_position_bias_table")}
    print(f"swin trainer step 1: {len(tables)} relative-position bias tables, smallest largest |gradient| "
          f"{min(tables.values())}")
    check(len(tables) == 12 and min(tables.values()) > 0, f"swin trainer: a bias table has no gradient {tables}")
    del card, host, grads, lc, lh, loss_c, loss_h

    # 8.2 mixup/cutmix arithmetic on the card against the CPU, from the same draws
    xm, ym = batch(TRAIN_BATCH)
    for use_cutmix in (False, True):
        draws = draw_mixup(mix_cfg, 224, 224, rng)._replace(use_cutmix=use_cutmix)
        (ic, tc), (ih, th) = apply_mixup(xm.to(dev), ym.to(dev), mix_cfg, draws), apply_mixup(xm, ym, mix_cfg, draws)
        print(f"swin trainer: {'cutmix' if use_cutmix else 'mixup'} {draws} at batch {TRAIN_BATCH}: images card vs "
              f"CPU max_abs_err {float((ic.cpu() - ih).abs().max())}, targets {float((tc.cpu() - th).abs().max())} "
              "(tolerance 0)")
        check(torch.equal(ic.cpu(), ih) and torch.equal(tc.cpu(), th), f"swin trainer: {draws} differs card vs CPU")

    # 8.3 train steps at TRAIN_BATCH with drop-path 0.1, mixup/cutmix, AdamW and the EMA
    model = create_model("swin_tiny", dev, seed=SEED, drop_path_rate=TRAIN_DROP_PATH)
    sched = cosine_schedule(TRAIN_LR, TRAIN_STEPS + 1, 1, warmup_epochs=0, warmup_lr=TRAIN_LR)
    state = create_train_state(model, AdamW(sched, weight_decay=TRAIN_WD), ema_decay=TRAIN_EMA, device=dev)
    step = make_train_step(model, ema_decay=TRAIN_EMA)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    batches = [tuple(a.to(dev) for a in batch(TRAIN_BATCH)) for _ in range(TRAIN_STEPS + 1)]

    def mixed_step(x, y):
        return step(state, *mixup_cutmix(x, y, mix_cfg, rng, device=dev), gen)[1]["loss"]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    losses = [mixed_step(*batches[0])]  # the warm-up step
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for x, y in batches[1:]:
        losses.append(mixed_step(x, y))
    end.record()
    end.synchronize()
    step_ms = start.elapsed_time(end) / TRAIN_STEPS
    peak = torch.cuda.max_memory_allocated(dev)
    losses = [v.item() for v in losses]
    print(f"swin trainer: swin_tiny, batch {TRAIN_BATCH}, drop-path {TRAIN_DROP_PATH}, mixup/cutmix {tuple(mix_cfg)}, "
          f"AdamW lr {TRAIN_LR} weight decay {TRAIN_WD}, EMA {TRAIN_EMA}: losses {losses}; {step_ms} ms/step, "
          f"{TRAIN_BATCH * 1000 / step_ms} images/s over {TRAIN_STEPS} steps after a warm-up step (CUDA events, "
          f"mixup/cutmix included); max_memory_allocated {peak} bytes ({peak / 2**30:.3f} GiB)")
    check(all(math.isfinite(v) for v in losses), f"swin trainer: a non-finite loss {losses}")
    ranges = dict(model.named_buffers())
    unset = [n for n in ranges if n.endswith("min_val") and not ranges[n] < ranges[n[:-7] + "max_val"]]
    check(not unset, f"swin trainer: ranges not set (min >= max): {unset}")
    profile_step("swin trainer", lambda: mixed_step(*batches[1]), step_ms)

    # 8.4 freeze the trained state (its EMA weights) and serve it by K7 + K3
    t0 = time.perf_counter()
    variables = eval_variables(state)
    art = freeze_swin(model, variables, device=dev)
    del batches, state, step
    torch.cuda.empty_cache()
    infer = build_swin_infer(art, dev)
    images, _ = batch(BATCH)
    images_dev = images.to(dev)
    for w in WRAPPERS.values():
        w.launches = 0
    logits = infer(images_dev)
    torch.cuda.synchronize()
    counts = {k: w.launches for k, w in WRAPPERS.items() if w.launches}
    blocks = sum(art["config"]["depths"])
    cpu2 = build_swin_infer(art, "cpu", kernels=())(images[:2])
    with torch.no_grad():
        sim = torch.func.functional_call(model, {**variables["params"], **variables["quant_stats"]},
                                         (images_dev,), {"train": False})
    head = float(np.max(art["head"]["out_scale"]))
    e_sim = float((logits - sim).abs().max())
    top2 = sim.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > 8 * head
    agree = logits.argmax(-1) == sim.argmax(-1)
    print(f"swin trainer: frozen (EMA weights) and served by {sorted(infer.kernels)} at batch {BATCH}: launches "
          f"{counts}; rows 0-1 vs the plain engine on the CPU max_abs_err {float((logits[:2].cpu() - cpu2).abs().max())} "
          f"(tolerance 0); vs the SIM eval forward on the card max_abs_err {e_sim} (bound 4 x head out_scale "
          f"{4 * head}); argmax equal on {int(agree.sum())} of {BATCH} rows, on {int(agree[clear].sum())} of the "
          f"{int(clear.sum())} whose top two SIM logits lie more than 8 head scales apart; in "
          f"{time.perf_counter() - t0:.3f} s")
    check(counts == {"K7": blocks, "K3": 2 * blocks + len(art["config"]["depths"])}, f"swin trainer serve: launches {counts}")
    check(torch.equal(logits[:2].cpu(), cpu2), "swin trainer serve: the engine differs from the CPU plain engine")
    check(e_sim <= 4 * head, "swin trainer serve: the engine is off the SIM eval forward")
    check(bool(agree[clear].all()), "swin trainer serve: argmax differs on a row with a clear SIM top logit")

    # K7 against its plain version on the trained model's first shifted block
    t = infer.tensors
    shifted = t["stages"][0]["blocks"][1]
    captured = {}

    def visit(layer, x) -> None:
        if layer is shifted:
            captured["qkv"] = window_attention_inputs(x, layer, kernels=())

    with torch.inference_mode():
        swin_trunk(patch_embed(images_dev, t), t, (), on_layer=visit)
    a = shifted["attn"]
    args = (*captured["qkv"], a["bias"], a["mask"], a["r1"], a["rb"], a["scale"], a["r_out"], shifted["heads"])
    e_k7 = max_abs_err(fused_int8_window_attention(*args), fused_int8_window_attention_reference(*args))
    print(f"swin trainer: K7 on the trained model's stage 1 block 1 inputs {tuple(captured['qkv'][0].shape)} masked, "
          f"s_bias {a['scale']}: max_abs_err {e_k7} against its plain version (tolerance 0)")
    check(shifted["shift"] > 0 and a["mask"] is not None and e_k7 == 0, "swin trainer: K7 differs on the trained model")


class RunKilled(Exception):
    """Raised in place of a CLI's train step: the run dies there."""


def probe_cli_steps(profile: tuple | None = None, kill_at: int | None = None):
    """Wrap ``ivit_tpu_torch.train.make_train_step``, which ``quant_train``
    looks up when it starts, for the in-process CLI runs: the wrapper
    records the host time at the start of each step; with ``profile`` =
    (first, stop) it runs the CLI's steps first .. stop-1 under
    torch.profiler (from a synchronize before step ``first`` to one
    before step ``stop``: the steps and the CLI's host work between
    them); with ``kill_at`` it raises ``RunKilled`` in place of that
    step. Returns the record and a function that undoes the wrap."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    import ivit_tpu_torch.train as train_pkg

    real = train_pkg.make_train_step
    record: dict = {"starts": []}

    def make(*args, **kwargs):
        step = real(*args, **kwargs)

        def timed(*step_args):
            i = len(record["starts"])
            if profile and i == profile[1] and "prof" in record:
                torch.cuda.synchronize()
                prof = record.pop("prof")
                prof.stop()
                record["wall_ms"] = (time.perf_counter() - record.pop("t0")) * 1e3
                kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
                record["busy_ms"] = sum(e.self_device_time_total for e in kernels) / 1e3
                record["kernels"] = sum(e.count for e in kernels)
            if profile and i == profile[0]:
                torch.cuda.synchronize()
                record["prof"] = torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
                record["prof"].start()
                record["t0"] = time.perf_counter()
            if i == kill_at:
                raise RunKilled(f"killed before step {i}")
            record["starts"].append(time.perf_counter())
            return step(*step_args)

        return timed

    train_pkg.make_train_step = make
    return record, lambda: setattr(train_pkg, "make_train_step", real)


def epoch_losses(log_path: str, epoch: int) -> list:
    """The losses of ``epoch``'s steps, from the last such line of a
    quant_train log."""
    with open(log_path) as f:
        found = re.findall(rf"epoch {epoch} losses (\[.*\])", f.read())
    check(bool(found), f"{log_path}: no losses logged for epoch {epoch}")
    return ast.literal_eval(found[-1])


def engine_vs_sim(label: str, sim_path: str, eng_path: str, art: dict) -> None:
    """``tests/test_dump_logits.py``'s checks of the engine's dumped
    logits against the SIM model's: the same labels in the same order,
    the logits within CLI_HEAD_SCALES head output scales, the argmax
    equal on every row whose top two SIM logits lie more than
    CLI_CLEAR_SCALES head scales apart."""
    import numpy as np

    sim, eng = np.load(sim_path), np.load(eng_path)
    n = len(eng["labels"])
    check(len(sim["labels"]) >= n and np.array_equal(sim["labels"][:n], eng["labels"]),
          f"{label}: the dumps' labels differ")
    s, e = sim["logits"][:n], eng["logits"]
    head = float(np.max(art["head"]["out_scale"]))
    err = float(np.abs(e - s).max())
    top2 = np.sort(s, -1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > CLI_CLEAR_SCALES * head
    agree = s.argmax(-1) == e.argmax(-1)
    print(f"{label}: engine vs SIM over {n} images, labels equal; logits max_abs_err {err} (bound "
          f"{CLI_HEAD_SCALES} x head out_scale {CLI_HEAD_SCALES * head}); argmax equal on {int(agree.sum())} of {n} "
          f"rows, on {int(agree[clear].sum())} of the {int(clear.sum())} whose top two SIM logits lie more than "
          f"{CLI_CLEAR_SCALES} head scales apart")
    check(err <= CLI_HEAD_SCALES * head, f"{label}: the engine is off the SIM logits")
    check(bool(agree[clear].all()), f"{label}: argmax differs on a row with a clear SIM top logit")


def cli_images(dev):
    """The synthetic validation set's first BATCH images at CLI_SIZE, as
    ``evaluate_accuracy`` transforms them, on ``dev``."""
    import numpy as np
    import torch

    from ivit_tpu_torch.data import SyntheticDataset
    from ivit_tpu_torch.data.transforms import EvalTransform

    return torch.from_numpy(np.stack([EvalTransform(CLI_SIZE)(SyntheticDataset(BATCH, CLI_SIZE).load(i)[0])
                                      for i in range(BATCH)])).to(dev)


def vit_kernels_on_artifact(label: str, art: dict, images, dev) -> None:
    """K1 and K3 against their plain versions (tolerance 0) on the ViT
    artifact's own inputs (block 0's norm1 input and q, k, v), and its
    kernel engine's logits against the plain engine's."""
    import torch

    from ivit_tpu_torch.deploy.engine import attention_inputs, build_vit_infer, embed
    from ivit_tpu_torch.kernels import (
        fused_int8_attention,
        fused_int8_attention_reference,
        fused_layernorm_requant,
        fused_layernorm_requant_reference,
    )

    infer = build_vit_infer(art, dev)
    t, cfg = infer.tensors, art["config"]
    blk = t["blocks"][0]
    with torch.inference_mode():
        x = embed(images, t)
        norm_args = (x.reshape(-1, cfg["embed_dim"]), blk["norm1"]["bias_int"], blk["norm1"]["ratio"])
        e_k3 = max_abs_err(fused_layernorm_requant(*norm_args), fused_layernorm_requant_reference(*norm_args))
        q, k, v = attention_inputs(x, blk, cfg["num_heads"])
        a = blk["attn"]
        attn_args = (q, k, v, a["r1"], a["scale"], a["r_out"], int(cfg["softmax_bits"]))
        e_k1 = max_abs_err(fused_int8_attention(*attn_args), fused_int8_attention_reference(*attn_args))
        same = torch.equal(infer(images), build_vit_infer(art, dev, kernels=())(images))
    torch.cuda.synchronize()
    print(f"{label} artifact: K3 on block 0's norm1 input {tuple(norm_args[0].shape)} max_abs_err {e_k3}, "
          f"K1 on block 0's q, k, v {tuple(q.shape)} at softmax_bits {cfg['softmax_bits']} max_abs_err {e_k1} "
          f"(tolerance 0); logits of {sorted(infer.kernels)} equal to the plain engine's {same}")
    check(e_k3 == 0 and e_k1 == 0 and same, f"{label}: a kernel differs from its plain version")


def swin_kernels_on_artifact(label: str, art: dict, images, dev) -> None:
    """K7 and K3 against their plain versions (tolerance 0) on the Swin
    artifact's own inputs (stage 1: block 0's norm1 input, block 1's
    shifted and masked windows), and its kernel engine's logits against
    the plain engine's."""
    import torch

    from ivit_tpu_torch.deploy.swin_engine import build_swin_infer, patch_embed, swin_trunk, window_attention_inputs
    from ivit_tpu_torch.kernels import (
        fused_int8_window_attention,
        fused_int8_window_attention_reference,
        fused_layernorm_requant,
        fused_layernorm_requant_reference,
    )

    infer = build_swin_infer(art, dev)
    st = infer.tensors
    stage = st["stages"][0]
    seen_inputs = {}

    def visit(layer, x) -> None:
        if layer is stage["blocks"][0]:
            seen_inputs["norm"] = x.reshape(-1, x.shape[-1])
        if layer is stage["blocks"][1]:
            seen_inputs["qkv"] = window_attention_inputs(x, layer, kernels=())

    with torch.inference_mode():
        swin_trunk(patch_embed(images, st), st, (), on_layer=visit)
        b0, b1 = stage["blocks"]
        norm_args = (seen_inputs["norm"], b0["norm1"]["bias_int"], b0["norm1"]["ratio"])
        e_k3 = max_abs_err(fused_layernorm_requant(*norm_args), fused_layernorm_requant_reference(*norm_args))
        a = b1["attn"]
        win_args = (*seen_inputs["qkv"], a["bias"], a["mask"], a["r1"], a["rb"], a["scale"], a["r_out"], b1["heads"])
        e_k7 = max_abs_err(fused_int8_window_attention(*win_args), fused_int8_window_attention_reference(*win_args))
        same = torch.equal(infer(images), build_swin_infer(art, dev, kernels=())(images))
    torch.cuda.synchronize()
    print(f"{label} artifact: K3 on stage 1 block 0's norm1 input {tuple(norm_args[0].shape)} max_abs_err "
          f"{e_k3}, K7 on stage 1 block 1's shifted windows {tuple(seen_inputs['qkv'][0].shape)} max_abs_err "
          f"{e_k7} (tolerance 0); logits of {sorted(infer.kernels)} equal to the plain engine's {same}")
    check(b1["shift"] > 0 and e_k3 == 0 and e_k7 == 0 and same, f"{label}: a kernel differs from its plain version")


def serve_checkpoint(label: str, ckpt: str, train_args: list, out_dir: str, dev) -> dict:
    """A trainer checkpoint to the served engine, in process: ``quant_train
    --eval --resume --dump-logits`` (the SIM logits), ``convert_model
    --checkpoint`` (every flag from the record), ``evaluate_accuracy
    --dump-logits`` at batch BATCH on the captured engine, with every
    launch count set to 0 just before it and read just after (K1 + K3 a
    forward for a ViT, K7 + K3 for a Swin); the engine's logits against
    the SIM dump (``engine_vs_sim``). Returns the artifact."""
    import gc

    import torch

    from ivit_tpu_torch import convert_model, evaluate_accuracy, quant_train
    from ivit_tpu_torch.deploy.graphs import FORWARDS
    from ivit_tpu_torch.kernels import WRAPPERS
    from ivit_tpu_torch.utils import load_artifact

    t1 = time.perf_counter()
    os.makedirs(out_dir, exist_ok=True)
    sim, art_path, eng = (os.path.join(out_dir, f) for f in ("sim.npz", "artifact.pkl", "eng.npz"))
    device_args = ["--device", str(dev)]
    quant_train.main([*train_args, *device_args, "--eval", "--resume", ckpt, "--dump-logits", sim,
                      "--output-dir", out_dir])
    convert_model.main(["--checkpoint", ckpt, "--output", art_path, *device_args])
    gc.collect()
    torch.cuda.empty_cache()
    print(f"{label}: quant_train --eval --dump-logits and convert_model --checkpoint {time.perf_counter() - t1:.3f} s")
    t1 = time.perf_counter()
    art = load_artifact(art_path)
    cfg = art["config"]
    model = train_args[train_args.index("--model") + 1]
    for w in WRAPPERS.values():
        w.launches = 0
    top1, top5, seen = evaluate_accuracy.main(["--model", model, "--artifact", art_path, *CLI_EVAL,
                                               "--batch-size", str(BATCH), "--dump-logits", eng, *device_args])
    counts = {k: w.launches for k, w in WRAPPERS.items() if w.launches}
    if "depths" in cfg:
        blocks = sum(cfg["depths"])
        per_forward = {"K7": blocks, "K3": 2 * blocks + len(cfg["depths"])}
    else:
        per_forward = {"K1": cfg["depth"], "K3": 2 * cfg["depth"] + 1}
    print(f"{label} evaluate_accuracy: top1 {100 * top1 / seen} top5 {100 * top5 / seen} over {seen}; "
          f"launches {counts} through the capture's {FORWARDS} forwards, {per_forward} a forward "
          f"expected; {time.perf_counter() - t1:.3f} s")
    check(counts == {k: FORWARDS * n for k, n in per_forward.items()}, f"{label} evaluate_accuracy: launches {counts}")
    engine_vs_sim(label, sim, eng, art)
    return art


def zoo_int8_matmul(dev) -> None:
    """``ops.intmm.int8_matmul`` at every GEMM of the registry's models, at
    the row counts the CLIs give it, against the exact product (the full
    sweep, every M to 2,048 as well, is scripts/torch_int_mm_domain.py)."""
    import importlib.util

    import torch

    from ivit_tpu_torch.ops.intmm import int8_matmul

    t0 = time.perf_counter()
    spec = importlib.util.spec_from_file_location("torch_int_mm_domain",
                                                  os.path.join(REPO, "scripts", "torch_int_mm_domain.py"))
    domain = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(domain)
    zoo = domain.zoo_gemms()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    shapes, bad = 0, []
    for (K, N), tokens in sorted(zoo.items()):
        w = torch.randint(-128, 128, (K, N), generator=gen, dtype=torch.int8, device=dev)
        rows = sorted({b * t for b in domain.CLI_BATCHES for t in tokens})
        x_all = torch.randint(-128, 128, (rows[-1], K), generator=gen, dtype=torch.int8, device=dev)
        exact_all = (x_all.to(torch.float64) @ w.to(torch.float64)).to(torch.int32)
        for M in rows:
            shapes += 1
            if not torch.equal(int8_matmul(x_all[:M], w), exact_all[:M]):
                bad.append((M, K, N))
        del x_all, exact_all
    print(f"int8_matmul at the zoo's {len(zoo)} GEMM widths x the CLIs' row counts at batches "
          f"{domain.CLI_BATCHES}: {shapes} shapes, not exact at {bad} (tolerance 0), in "
          f"{time.perf_counter() - t0:.3f} s")
    check(not bad, f"int8_matmul is not exact at {bad}")


def cli_phase(dev, library_step_ms: float) -> None:
    """Phase 9: the trainer's entry points on the card (module docstring)."""
    import gc
    import importlib.util

    import numpy as np
    import torch

    from ivit_tpu_torch import convert_model, quant_train
    from ivit_tpu_torch.data import DataLoader, SyntheticDataset
    from ivit_tpu_torch.data.transforms import TrainTransform
    from ivit_tpu_torch.nn.flax_state import flatten
    from ivit_tpu_torch.utils import load_artifact, load_checkpoint_raw

    t_phase = time.perf_counter()
    device_args = ["--device", str(dev)]

    zoo_int8_matmul(dev)

    # 9.0 Pillow on this machine, and the loader's rate on its host (the
    # Pillow-free train transform: numpy bicubic crop, flip, normalize,
    # erasing) with 8 threads and with 8 processes
    print(f"Pillow importable here: {importlib.util.find_spec('PIL') is not None} (the CLI runs below use "
          "--aa none --color-jitter 0, which import none)")
    for procs in (False, True):
        loader = DataLoader(SyntheticDataset(512, CLI_SIZE), CLI_TRAIN_BATCH,
                            TrainTransform(CLI_SIZE, color_jitter_strength=0.0, use_rand_augment=False),
                            num_workers=8, use_processes=procs)
        it = iter(loader)
        next(it)  # the pool's start
        t0 = time.perf_counter()
        n_img = sum(len(next(it)[1]) for _ in range(4))
        load_s = time.perf_counter() - t0
        del it
        print(f"loader: {n_img / load_s} images/s at {CLI_SIZE} (4 batches of {CLI_TRAIN_BATCH}, 8 "
              f"{'spawned processes (--loader-procs)' if procs else 'threads (the default)'}, host clock, "
              f"{os.cpu_count()} host cores)")

    with tempfile.TemporaryDirectory() as tmp:
        def d(*parts):
            return os.path.join(tmp, *parts)

        def train(name: str, *extra, profile=None, kill_at=None) -> dict:
            t1 = time.perf_counter()
            record, undo = probe_cli_steps(profile, kill_at)
            try:
                quant_train.main([*CLI_TRAIN, *CLI_DEIT, *device_args, *extra, "--output-dir", d(name)])
            except RunKilled:
                check(kill_at is not None, f"quant_train {name}: killed unasked")
            finally:
                undo()
            gc.collect()
            torch.cuda.empty_cache()
            print(f"cli quant_train {name} {' '.join(extra)}: {time.perf_counter() - t1:.3f} s")
            return record

        # 9.1 DeiT-S, full width and depth, at 224: a two-epoch run killed
        # before the first step of epoch 1 (after epoch 0's checkpoints),
        # then --resume; two uninterrupted two-epoch runs. (The cosine
        # schedule spans --epochs, so an --epochs 1 run would take other
        # learning rates in epoch 0 from its third step on.)
        first = train("split", "--epochs", "2", kill_at=CLI_DEIT_STEPS)
        check(os.path.exists(d("split", "checkpoint.pkl")) and os.path.exists(d("split", "best.pkl")),
              "quant_train wrote no checkpoint.pkl or best.pkl")
        starts = first["starts"]
        cli_ms = (starts[3] - starts[1]) / 2 * 1e3
        print(f"cli train step: {cli_ms} ms/step, steps 1-2 of epoch 0 (host clock from a step's start to the "
              f"next's: the loader's wait, mixup, the step and reading its loss); the library's step in phase 7 "
              f"{library_step_ms} ms (CUDA events, batch {TRAIN_BATCH}); ratio {cli_ms / library_step_ms}")
        train("split", "--epochs", "2", "--resume", d("split", "checkpoint.pkl"))
        train("whole1", "--epochs", "2")
        prof = train("whole2", "--epochs", "2", profile=(1, 3))
        print(f"cli train steps 1-2 profiled: kernel time {prof['busy_ms']} ms in {prof['wall_ms']} ms wall, idle "
              f"share {1 - prof['busy_ms'] / prof['wall_ms']}; {prof['kernels']} kernels")
        losses = {name: epoch_losses(d(name, "log.log"), 1) for name in ("split", "whole1", "whole2")}
        params = {name: flatten(load_checkpoint_raw(d(name, "checkpoint.pkl"))[0]["params"])
                  for name in ("split", "whole1", "whole2")}

        def gaps(a: str, b: str) -> tuple:
            return (max(abs(x - y) for x, y in zip(losses[a], losses[b])),
                    max(float(np.abs(params[a][k] - params[b][k]).max()) for k in params[b]))

        resume_gap, runs_gap = gaps("split", "whole1"), gaps("whole1", "whole2")
        print(f"cli resume: epoch-1 losses resumed {losses['split']}, uninterrupted {losses['whole1']} and "
              f"{losses['whole2']}; resumed vs uninterrupted: loss {resume_gap[0]}, parameters {resume_gap[1]}; "
              f"two uninterrupted runs: loss {runs_gap[0]}, parameters {runs_gap[1]} (largest absolute gaps)")
        check(len(losses["split"]) == len(losses["whole1"]) == CLI_DEIT_STEPS, f"cli resume: steps {losses}")
        check(resume_gap[0] <= runs_gap[0] and resume_gap[1] <= runs_gap[1],
              "cli resume: the resumed run differs from the uninterrupted one more than two uninterrupted runs do")
        del params

        # 9.2 - 9.5 the SIM logits, the conversion, the engine's accuracy
        art = serve_checkpoint(f"cli {CLI_DEIT[1]}", d("whole1", "checkpoint.pkl"), [*CLI_TRAIN, *CLI_DEIT],
                               d("serve"), dev)

        images = cli_images(dev)
        vit_kernels_on_artifact(f"cli {CLI_DEIT[1]}", art, images, dev)

        # 9.6 Swin-T: train through python -m, the SIM logits, convert,
        # evaluate one batch on K7 + K3
        t1 = time.perf_counter()
        swin_train = [*CLI_TRAIN, *CLI_SWIN, *device_args]
        run_cli(["ivit_tpu_torch.quant_train", *swin_train, "--epochs", "1", "--output-dir", d("swin")], 900)
        sckpt = d("swin", "checkpoint.pkl")
        quant_train.main([*swin_train, "--eval", "--resume", sckpt, "--dump-logits", d("swin_sim.npz"),
                          "--output-dir", d("swin_eval")])
        convert_model.main(["--checkpoint", sckpt, "--output", d("swin.pkl"), *device_args])
        gc.collect()
        torch.cuda.empty_cache()
        lines = run_cli(["ivit_tpu_torch.evaluate_accuracy", "--model", CLI_SWIN[1], "--artifact", d("swin.pkl"),
                         *CLI_EVAL, "--batch-size", str(BATCH), "--max-batches", "1",
                         "--dump-logits", d("swin_eng.npz"), *device_args], 600)
        sart = load_artifact(d("swin.pkl"))
        blocks = sum(sart["config"]["depths"])
        captured = re.search(r"launches a forward (\{.*\})", "\n".join(lines))
        check(captured is not None and ast.literal_eval(captured.group(1)) == {
            "K7": blocks, "K3": 2 * blocks + len(sart["config"]["depths"])},
            f"cli evaluate_accuracy {CLI_SWIN[1]}: launches a forward {captured and captured.group(1)}")
        print(f"cli {CLI_SWIN[1]}: train, --eval --dump-logits, convert and evaluate_accuracy in "
              f"{time.perf_counter() - t1:.3f} s")
        engine_vs_sim(f"cli {CLI_SWIN[1]}", d("swin_sim.npz"), d("swin_eng.npz"), sart)

        swin_kernels_on_artifact(f"cli {CLI_SWIN[1]}", sart, images, dev)
        del images
    gc.collect()
    torch.cuda.empty_cache()
    print(f"cli phase: {time.perf_counter() - t_phase:.3f} s")


def seeded_state_dict(name: str, gen, grid: int = 0) -> dict:
    """A float checkpoint's state dict in the published layout of registered
    model ``name`` at CLI_SIZE (DeiT/ViT: timm's; Swin: the official
    release's, with its ``relative_position_index`` and ``attn_mask``
    buffers), drawn from the torch generator ``gen``: LayerNorm weights
    1 + N(0, 0.1²), every other parameter N(0, 0.02²); a ViT's position
    embedding on a ``grid`` x ``grid`` patch grid."""
    import numpy as np
    import torch

    from ivit_tpu_torch.models import create_config
    from ivit_tpu_torch.models.swin import relative_position_index, stage_geometry, sw_attn_mask

    swin = name.startswith("swin")
    cfg = create_config(name, img_size=CLI_SIZE, **({"window_size": PRE_WINDOW} if swin else {}))
    D, p = cfg["embed_dim"], cfg["patch_size"]
    shapes = {"patch_embed.proj.weight": (D, 3, p, p), "patch_embed.proj.bias": (D,)}
    buffers = {}

    def norm(prefix, n):
        shapes[f"{prefix}.weight"], shapes[f"{prefix}.bias"] = (n,), (n,)

    def linear(prefix, n_in, n_out, bias=True):
        shapes[f"{prefix}.weight"] = (n_out, n_in)
        if bias:
            shapes[f"{prefix}.bias"] = (n_out,)

    def block(prefix, dim):
        hidden = int(dim * cfg["mlp_ratio"])
        norm(f"{prefix}.norm1", dim)
        linear(f"{prefix}.attn.qkv", dim, 3 * dim)
        linear(f"{prefix}.attn.proj", dim, dim)
        norm(f"{prefix}.norm2", dim)
        linear(f"{prefix}.mlp.fc1", dim, hidden)
        linear(f"{prefix}.mlp.fc2", hidden, dim)

    if swin:
        norm("patch_embed.norm", D)
        for i, depth in enumerate(cfg["depths"]):
            dim = D * 2**i
            for j in range(depth):
                pre = f"layers.{i}.blocks.{j}"
                res, ws, shift = stage_geometry(cfg, i, j)
                block(pre, dim)
                shapes[f"{pre}.attn.relative_position_bias_table"] = ((2 * ws - 1) ** 2, cfg["num_heads"][i])
                buffers[f"{pre}.attn.relative_position_index"] = torch.from_numpy(
                    relative_position_index(ws).astype(np.int64))
                if shift:
                    buffers[f"{pre}.attn_mask"] = torch.from_numpy(sw_attn_mask(res, res, ws, shift))
            if i < len(cfg["depths"]) - 1:
                norm(f"layers.{i}.downsample.norm", 4 * dim)
                linear(f"layers.{i}.downsample.reduction", 4 * dim, 2 * dim, bias=False)
        nf = D * 2 ** (len(cfg["depths"]) - 1)
    else:
        shapes["cls_token"], shapes["pos_embed"] = (1, 1, D), (1, grid * grid + 1, D)
        for i in range(cfg["depth"]):
            block(f"blocks.{i}", D)
        nf = D
    norm("norm", nf)
    linear("head", nf, cfg["num_classes"])
    sd = {}
    for key, shape in shapes.items():
        t = torch.randn(shape, generator=gen)
        sd[key] = 1 + 0.1 * t if len(shape) == 1 and key.endswith(".weight") else 0.02 * t
    return {**sd, **buffers}


def seeded_augreg_npz(name: str, rng) -> dict:
    """An augreg ``.npz`` checkpoint's arrays for registered ViT ``name``
    at CLI_SIZE, drawn from the numpy generator ``rng`` as
    ``seeded_state_dict`` draws."""
    import numpy as np

    from ivit_tpu_torch.models import create_config

    cfg = create_config(name, img_size=CLI_SIZE)
    D, H, p = cfg["embed_dim"], cfg["num_heads"], cfg["patch_size"]
    hd, hidden = D // H, int(D * cfg["mlp_ratio"])
    shapes = {"cls": (1, 1, D), "Transformer/posembed_input/pos_embedding": (1, (CLI_SIZE // p) ** 2 + 1, D),
              "embedding/kernel": (p, p, 3, D), "embedding/bias": (D,), "Transformer/encoder_norm/scale": (D,),
              "Transformer/encoder_norm/bias": (D,), "head/kernel": (D, cfg["num_classes"]),
              "head/bias": (cfg["num_classes"],)}
    for i in range(cfg["depth"]):
        src = f"Transformer/encoderblock_{i}"
        att = f"{src}/MultiHeadDotProductAttention_1"
        for ln in ("LayerNorm_0", "LayerNorm_2"):
            shapes[f"{src}/{ln}/scale"], shapes[f"{src}/{ln}/bias"] = (D,), (D,)
        for n in ("query", "key", "value"):
            shapes[f"{att}/{n}/kernel"], shapes[f"{att}/{n}/bias"] = (D, H, hd), (H, hd)
        shapes[f"{att}/out/kernel"], shapes[f"{att}/out/bias"] = (H, hd, D), (D,)
        shapes[f"{src}/MlpBlock_3/Dense_0/kernel"], shapes[f"{src}/MlpBlock_3/Dense_0/bias"] = (D, hidden), (hidden,)
        shapes[f"{src}/MlpBlock_3/Dense_1/kernel"], shapes[f"{src}/MlpBlock_3/Dense_1/bias"] = (hidden, D), (D,)
    out = {}
    for key, shape in shapes.items():
        t = rng.standard_normal(shape, dtype=np.float32)
        out[key] = (1 + np.float32(0.1) * t) if key.endswith("/scale") else np.float32(0.02) * t
    return out


def leaves_equal(label: str, got: dict, want: dict) -> int:
    """Every leaf of the nested ``want`` in ``got`` under the same path,
    bit for bit, and no other; returns the count."""
    import numpy as np

    from ivit_tpu_torch.nn.flax_state import flatten

    got, want = flatten(got), flatten(want)
    check(got.keys() == want.keys(), f"{label}: leaves {sorted(set(got) ^ set(want))[:6]} on one side only")
    bad = [k for k in want if not np.array_equal(got[k], want[k])]
    check(not bad, f"{label}: leaves differ from the checkpoint's: {bad[:6]}")
    return len(want)


def fast_matmul_phase(model, images, dev) -> None:
    """One train-mode step of the calibrated ``model`` (a DeiT-S QAT model
    on imported weights) with ``--fast-matmul``'s switch off and on, on
    the same batch: logits and loss bit-equal, every gradient within
    FAST_GRAD_RTOL of its float32 value; then the trainer's step
    (``make_train_step``, AdamW, the EMA) timed each way in turns."""
    import copy

    import torch

    from ivit_tpu_torch.nn import quant
    from ivit_tpu_torch.train import AdamW, create_train_state, make_train_step, soft_target_cross_entropy

    x = images[:TRAIN_BATCH]
    classes = model.config["num_classes"]
    targets = torch.full((TRAIN_BATCH, classes), TRAIN_SMOOTHING / classes, device=dev)
    targets[torch.arange(TRAIN_BATCH), torch.arange(TRAIN_BATCH) % classes] += 1 - TRAIN_SMOOTHING
    runs = {}
    try:
        for fast in (False, True):
            quant.SIM_FAST_MATMUL = fast
            m = copy.deepcopy(model)
            logits = m(x, train=True)
            loss = soft_target_cross_entropy(logits, targets)
            grads = torch.autograd.grad(loss, list(m.parameters()), materialize_grads=True)
            runs[fast] = logits.detach(), loss.detach(), [g.detach() for g in grads]
            del m, logits, loss, grads
        names = [n for n, _ in model.named_parameters()]
        worst, worst_name = max((float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30), n)
                                for n, a, b in zip(names, runs[True][2], runs[False][2]))
        same = torch.equal(runs[True][0], runs[False][0]) and torch.equal(runs[True][1], runs[False][1])
        print(f"fast-matmul: {PRE_DEIT} step at batch {TRAIN_BATCH}: logits and loss bit-equal to the float32 step's "
              f"{same} (loss {float(runs[False][1])}); gradients off the float32 ones by at most {worst} of a leaf's "
              f"largest entry ({worst_name}; bound {FAST_GRAD_RTOL})")
        check(same, "fast-matmul: the forward differs from the float32 step's")
        check(worst <= FAST_GRAD_RTOL, f"fast-matmul: gradients beyond {FAST_GRAD_RTOL} ({worst_name})")
        del runs

        steps = {}
        for fast in (False, True):
            m = copy.deepcopy(model)
            state = create_train_state(m, AdamW(TRAIN_LR, weight_decay=TRAIN_WD), ema_decay=TRAIN_EMA, device=dev)
            steps[fast] = (state, make_train_step(m, ema_decay=TRAIN_EMA))
        times = {False: [], True: []}
        for fast in (False, True, True, False):
            quant.SIM_FAST_MATMUL = fast
            state, step = steps[fast]
            times[fast].append(cuda_ms(lambda: step(state, x, targets), TRAIN_STEPS, warmup=1))
        print(f"fast-matmul: {PRE_DEIT} train step at batch {TRAIN_BATCH}, turns float32, fast, fast, float32 (CUDA "
              f"events over {TRAIN_STEPS} steps after a warm-up): float32 {times[False]} ms, --fast-matmul "
              f"{times[True]} ms; ratio {sum(times[False]) / sum(times[True])}")
    finally:
        quant.SIM_FAST_MATMUL = False


def pretrained_phase(dev) -> None:
    """Phase 10: float checkpoints imported, calibrated, fine-tuned,
    frozen and served; the float models (module docstring)."""
    import copy
    import gc

    import numpy as np
    import torch

    from ivit_tpu_torch import quant_train
    from ivit_tpu_torch.models import create_model
    from ivit_tpu_torch.models.import_swin import torch_swin_to_params
    from ivit_tpu_torch.models.import_torch import (
        load_pretrained,
        merge_params,
        npz_vit_to_params,
        resize_pos_embed,
        torch_vit_to_params,
    )
    from ivit_tpu_torch.models.swin_float import swin_quant_params_to_float
    from ivit_tpu_torch.models.vit_float import quant_params_to_float
    from ivit_tpu_torch.nn import flax_variables, load_flax_variables

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    check(torch.get_float32_matmul_precision() == "highest", "phase 10: float32 matmuls would use TF32")
    gen = torch.Generator().manual_seed(SEED)
    images = torch.from_numpy(np.random.default_rng(SEED).standard_normal((BATCH, CLI_SIZE, CLI_SIZE, 3),
                                                                           dtype=np.float32)).to(dev)
    served_images = cli_images(dev)
    device_args = ["--device", str(dev)]
    with tempfile.TemporaryDirectory() as tmp:
        for name in (PRE_DEIT, PRE_SWIN):
            swin = name.startswith("swin")
            geometry = {"window_size": PRE_WINDOW} if swin else {}
            t1 = time.perf_counter()
            sd = seeded_state_dict(name, gen, grid=0 if swin else PRE_GRID)
            path = os.path.join(tmp, f"{name}.pth")
            torch.save({"model": sd}, path)

            # 10.1 the import, by load_pretrained, into the QAT model on the card
            qat = create_model(name, dev, seed=SEED, drop_path_rate=0.0, img_size=CLI_SIZE, **geometry)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            load_pretrained(path, name, qat)
            torch.cuda.synchronize()
            import_ms = (time.perf_counter() - t0) * 1e3
            want = (torch_swin_to_params if swin else torch_vit_to_params)(sd)
            ntok = 0
            if not swin:
                ntok = qat.pos_embed.shape[1]
                want["pos_embed"] = resize_pos_embed(want["pos_embed"], ntok)
            imported = flax_variables(qat)["params"]
            n_leaves = leaves_equal(f"{name} import", imported, want)
            print(f"pretrained {name}: a {os.path.getsize(path)}-byte .pth ({{'model': state dict}}, "
                  f"{len(sd)} entries) imported by load_pretrained in {import_ms} ms (host clock, to the card); "
                  f"all {n_leaves} parameter leaves equal to the importer's tree on the CPU")
            if not swin:
                grid_old, grid_new = PRE_GRID, round((ntok - 1) ** 0.5)
                g = sd["pos_embed"][:, 1:].reshape(1, grid_old, grid_old, -1).permute(0, 3, 1, 2).to(dev)
                ref = torch.nn.functional.interpolate(g, size=(grid_new, grid_new), mode="bicubic",
                                                      align_corners=False)
                ref = ref.permute(0, 2, 3, 1).reshape(1, -1, g.shape[1]).cpu()
                e_interp = float((qat.pos_embed[:, 1:].detach().cpu() - ref).abs().max())
                print(f"pretrained {name}: pos_embed {tuple(sd['pos_embed'].shape)} -> {tuple(qat.pos_embed.shape)} "
                      f"(bicubic, A = -0.75) bit-equal to the CPU's resize; F.interpolate on the card differs by "
                      f"{e_interp} (float32 rounding: its own order of multiply-adds)")
                check(e_interp <= 4e-6 + 1e-5 * float(ref.abs().max()), f"{name}: the resize is off torch's bicubic")

            # 10.2 the float model on the same weights, by the library path
            fm = create_model(f"{name}_fp32", dev, seed=SEED, img_size=CLI_SIZE, **geometry)
            rekeyed = (swin_quant_params_to_float if swin else quant_params_to_float)(imported)
            load_flax_variables(fm, {"params": merge_params(flax_variables(fm)["params"], rekeyed)})
            leaves_equal(f"{name}_fp32 load", flax_variables(fm)["params"], rekeyed)
            with torch.no_grad():
                f_logits = fm(images)
                float_ms = cuda_ms(lambda: fm(images), FLOAT_ITERS)
                f_cpu = copy.deepcopy(fm).cpu()(images[:2].cpu())
            e_float = float((f_logits[:2].cpu() - f_cpu).abs().max())
            bound = FLOAT_TOL + FLOAT_TOL * f_cpu.abs()
            print(f"pretrained {name}_fp32: {float_ms} ms a batch-{BATCH} forward (CUDA events over {FLOAT_ITERS}, "
                  f"TF32 off; the bench's true-FP32 DeiT-S leg read 40.93 ms in PERF.md §2); logits of images 0-1 "
                  f"against the CPU max_abs_err {e_float} (|logit| up to {float(f_cpu.abs().max())}; rtol = atol = "
                  f"{FLOAT_TOL})")
            check(bool(torch.isfinite(f_logits).all()) and bool(((f_logits[:2].cpu() - f_cpu).abs() <= bound).all()),
                  f"{name}_fp32: the card's logits are off the CPU's")
            del f_cpu

            # 10.3 the SIM model calibrated on the import, against the float model
            with torch.no_grad():
                for i in range(PRE_CALIB):
                    qat(images[i * TRAIN_BATCH:(i + 1) * TRAIN_BATCH], train=True)
                s_logits = qat(images)
            corr = float(np.corrcoef(f_logits.cpu().numpy().ravel(), s_logits.cpu().numpy().ravel())[0, 1])
            agree = float((f_logits.argmax(-1) == s_logits.argmax(-1)).float().mean())
            print(f"pretrained {name}: INT8 SIM (ranges from {PRE_CALIB} batches of {TRAIN_BATCH}) against the float "
                  f"model on {BATCH} images: logit correlation {corr} (bound > {SIM_FLOAT_CORR}), top-1 agreement "
                  f"{agree}")
            check(corr > SIM_FLOAT_CORR, f"{name}: the SIM logits do not follow the float model's")
            del fm, f_logits, s_logits

            if not swin:
                fast_matmul_phase(qat, images, dev)
            del qat
            gc.collect()
            torch.cuda.empty_cache()

            # 10.4 the CLI: --pretrained with calibration, a few steps, then served
            batch = PRE_SWIN_BATCH if swin else CLI_TRAIN_BATCH
            train_args = [*CLI_TRAIN, "--model", name, "--batch-size", str(batch),
                          "--max-steps-per-epoch", str(PRE_STEPS), "--epochs", "1",
                          *(["--window-size", str(PRE_WINDOW)] if swin else [])]
            out_dir = os.path.join(tmp, name)
            t0 = time.perf_counter()
            quant_train.main([*train_args, *device_args, "--pretrained", path, "--calib-batches", str(PRE_CALIB),
                              "--output-dir", out_dir])
            losses = epoch_losses(os.path.join(out_dir, "log.log"), 0)
            print(f"pretrained {name}: quant_train --pretrained --calib-batches {PRE_CALIB}, {PRE_STEPS} steps at "
                  f"batch {batch} and the validation: losses {losses}, {time.perf_counter() - t0:.3f} s")
            check(len(losses) == PRE_STEPS and all(math.isfinite(v) for v in losses), f"{name}: losses {losses}")
            gc.collect()
            torch.cuda.empty_cache()
            art = serve_checkpoint(f"pretrained {name}", os.path.join(out_dir, "checkpoint.pkl"), train_args,
                                   os.path.join(out_dir, "serve"), dev)
            (swin_kernels_on_artifact if swin else vit_kernels_on_artifact)(f"pretrained {name}", art,
                                                                              served_images, dev)
            del sd, art
            gc.collect()
            torch.cuda.empty_cache()
            print(f"pretrained {name}: {time.perf_counter() - t1:.3f} s")

        # 10.5 a float model through the CLI
        t0 = time.perf_counter()
        out_dir = os.path.join(tmp, "fp32")
        quant_train.main([*CLI_TRAIN, "--model", f"{PRE_DEIT}_fp32", "--batch-size", str(CLI_TRAIN_BATCH),
                          "--max-steps-per-epoch", str(PRE_STEPS), "--epochs", "1", *device_args,
                          "--output-dir", out_dir])
        losses = epoch_losses(os.path.join(out_dir, "log.log"), 0)
        print(f"pretrained {PRE_DEIT}_fp32: quant_train {PRE_STEPS} steps at batch {CLI_TRAIN_BATCH} and the "
              f"validation: losses {losses}, {time.perf_counter() - t0:.3f} s")
        check(len(losses) == PRE_STEPS and all(math.isfinite(v) for v in losses), f"{PRE_DEIT}_fp32: losses {losses}")

        # 10.6 an augreg .npz into a ViT
        arrays = seeded_augreg_npz(PRE_NPZ, np.random.default_rng(SEED))
        path = os.path.join(tmp, f"{PRE_NPZ}.npz")
        np.savez(path, **arrays)
        model = create_model(PRE_NPZ, dev, seed=SEED, img_size=CLI_SIZE)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        load_pretrained(path, PRE_NPZ, model)
        torch.cuda.synchronize()
        import_ms = (time.perf_counter() - t0) * 1e3
        n_leaves = leaves_equal(f"{PRE_NPZ} npz import", flax_variables(model)["params"],
                                npz_vit_to_params(arrays, model.config["depth"]))
        print(f"pretrained {PRE_NPZ}: a {os.path.getsize(path)}-byte augreg .npz imported by load_pretrained in "
              f"{import_ms} ms (host clock, to the card); all {n_leaves} parameter leaves equal to the importer's")
        del model, arrays
    gc.collect()
    torch.cuda.empty_cache()
    print(f"pretrained phase: {time.perf_counter() - t_phase:.3f} s")


# phase 11, the recompute: each model's largest batch without remat in
# the fit sweep of scripts/torch_train_memory.py, where the step is
# timed both ways; the batch of the step-1 comparison; timed steps
REMAT_MODELS = {"vit_large": 32, "swin_base": 64}
REMAT_BATCH = 128
REMAT_CMP_BATCH = 4
REMAT_STEPS = 2
HOST_CALLS = 200  # phase 11's host µs a wrapper call
EXPORT_ITERS = 5  # phase 11's batch-128 forwards a timing, each way in turns
EXPORT_RUNS = 20  # phase 11's batch-1 forwards a median
# the reloaded engines phase 11 times (strict mode, the slowest, is only checked)
TIMED_EXPORTS = ("main", "A", "B", "swin")
EXPORT_WORKERS = 5  # phase 11's export processes (tracing runs on the host, one core each)


def host_us(fn, calls: int = HOST_CALLS) -> float:
    """Host µs a call takes to return, the stream held by a spin kernel
    (about 0.2 ms a call) so that no call waits on the device."""
    import torch

    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(calls * 400_000)
    t1 = time.perf_counter()
    for _ in range(calls):
        fn()
    elapsed = time.perf_counter() - t1
    torch.cuda.synchronize()
    return elapsed / calls * 1e6


def wrapper_calls(kernels, dev) -> dict:
    """Each kernel wrapper of the package module ``kernels`` (an
    ``ivit_tpu_torch.kernels``, this checkout's or another's) as a call on
    seeded inputs at its path's batch-128 shape: K1 and K2 (768, 197,
    64), K3 (25216, 384), K4 (25216, 384) x (384, 1536), K5 (25216,
    1536), K6 (151296, 197), K7 Swin-T stage 1 masked (24576, 49, 32),
    K9 (25216, 1536), K10 ViT-L/16 at 384² (2048, 577, 64)."""
    import numpy as np
    import torch

    from ivit_tpu_torch.models.swin import sw_attn_mask

    rng = np.random.default_rng(SEED + 13)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def i8(*shape):
        return t(rng.integers(-128, 128, shape).astype(np.int8))

    def f32(x) -> float:
        return float(np.float32(x))

    q, k, v = i8(768, 197, 64), i8(768, 197, 64), i8(768, 197, 64)
    x16 = t(rng.integers(-3000, 3000, (25216, 384)).astype(np.int16))
    bias = t(np.floor(rng.standard_normal(384) * 2**20).astype(np.float32))
    ratio = t((rng.uniform(0.5, 2.0, 384) * np.sqrt(384) * 2.0**-25).astype(np.float32))
    x8, w_t = i8(25216, 384), i8(1536, 384)
    b = t(rng.integers(-(2**16), 2**16, 1536).astype(np.int32))
    r1 = t((rng.uniform(0.5, 2.0, 1536) * 1e-4).astype(np.float32))
    acc = t(rng.integers(-(2**20), 2**20, (25216, 1536)).astype(np.int32))
    scores = t(rng.integers(-(2**20), 2**20, (151296, 197)).astype(np.int32))
    wq, wk, wv = i8(24576, 49, 32), i8(24576, 49, 32), i8(24576, 49, 32)
    wbias = t(rng.integers(-40, 40, (3, 49, 49)).astype(np.float32))
    wmask = t(sw_attn_mask(56, 56, 7, 3) / np.float32(0.07))
    r_attn, s_in, r2 = f32(127.0 / (3 * 8 * 74.0**2)), f32(0.031), f32(0.7)
    table = i8(256)
    lq, lk, lv = i8(2048, 577, 64), i8(2048, 577, 64), i8(2048, 577, 64)
    return {
        "K1": lambda: kernels.fused_int8_attention(q, k, v, r_attn, f32(0.07), f32(0.05 / 128 / 0.021), 8),
        "K2": lambda: kernels.fused_int8_attention_v2(q, k, v, r_attn, f32(0.021), f32(0.05 / 32768 / 0.021), 197),
        "K3": lambda: kernels.fused_layernorm_requant(x16, bias, ratio),
        "K4": lambda: kernels.fused_linear_shiftgelu(x8, w_t.T, b, r1, s_in, r2),
        "K5": lambda: kernels.fused_requant_shiftgelu(acc, r1, s_in, r2),
        "K6": lambda: kernels.fused_requant_shiftmax(scores, f32(3.1e-5), f32(0.021), 197),
        "K7": lambda: kernels.fused_int8_window_attention(wq, wk, wv, wbias, wmask, r_attn, f32(0.8), f32(0.07),
                                                          f32(0.05 / 128 / 0.021), 3),
        "K9": lambda: kernels.fused_requant_stable_gelu(acc, b, r1, table),
        "K10": lambda: kernels.fused_int8_attention_long(lq, lk, lv, r_attn, f32(0.07), f32(0.05 / 128 / 0.021), 8),
    }


VIT_L384_BATCH = 32  # phase 6's ViT-L/16 at 384² batch (the plain path's 577-token attention is the largest part)


def vit_long_path(dev, build_vit_infer, capture_infer, forwards: int) -> dict:
    """Phase 6's ViT-L/16 at 384²: the main path above 256 tokens (K10),
    its launches counted around its own eager forward and its own
    capture; returns the launches a forward."""
    import numpy as np
    import torch

    from ivit_tpu_torch.deploy import synthetic_vit_artifact
    from ivit_tpu_torch.kernels import WRAPPERS

    art = synthetic_vit_artifact("vit_large", seed=SEED, img_size=384, softmax_bits=8, gelu_stable=True)
    cfg = art["config"]
    depth = cfg["depth"]
    expect = {"K10": depth, "K3": 2 * depth + 1, "K9": depth}
    rng = np.random.default_rng(SEED)
    images = torch.from_numpy(rng.standard_normal((VIT_L384_BATCH, 384, 384, 3), dtype=np.float32)).to(dev)
    infer = build_vit_infer(art, dev)
    check(infer.kernels == {"attention", "layernorm", "gelu_stable"}, f"vit_l384: kernels {sorted(infer.kernels)}")

    def counts() -> dict:
        return {k: w.launches for k, w in WRAPPERS.items() if w.launches}

    for w in WRAPPERS.values():
        w.launches = 0
    logits = infer(images)
    torch.cuda.synchronize()
    eager = counts()
    print(f"vit_l384 (ViT-L/16 at 384², {cfg['img_size'] // cfg['patch_size']}² + 1 tokens) batch "
          f"{VIT_L384_BATCH}: launches a forward {eager}")
    check(eager == expect, f"vit_l384: launches {eager}, expected {expect}")
    plain = build_vit_infer(art, dev, kernels=())(images)
    e_plain = float((logits - plain).abs().max())
    print(f"vit_l384: logits vs kernels=() on the card: max_abs_err {e_plain} (tolerance 0); distinct argmax "
          f"{int(logits.argmax(-1).unique().numel())}, logit std {float(logits.std())}")
    check(torch.equal(logits, plain), "vit_l384: differs from kernels=() on the card")
    del plain
    for w in WRAPPERS.values():
        w.launches = 0
    graphed = capture_infer(infer, VIT_L384_BATCH, 384, dev)
    captured = counts()
    out = graphed(images)
    torch.cuda.synchronize()
    print(f"vit_l384 graph: launches through the capture's {forwards} forwards {captured}, in the plain capture "
          f"{graphed.launches}")
    check(graphed.launches == expect, f"vit_l384 graph: {graphed.launches} launches a forward")
    check(captured == {k: forwards * n for k, n in expect.items()}, f"vit_l384 graph: launches {captured}")
    check(counts() == captured, "vit_l384 graph: a replay counted launches")
    check(torch.equal(out, logits), "vit_l384 graph: replay differs from eager")
    ms = cuda_ms(lambda: graphed(images), 5)
    print(f"vit_l384 graph batch {VIT_L384_BATCH}: replay logits vs eager: max_abs_err "
          f"{float((out - logits).abs().max())} (tolerance 0); {ms} ms/forward, "
          f"{VIT_L384_BATCH / ms * 1e3} images/s (CUDA events)")
    per_forward = dict(graphed.launches)
    del graphed, out, infer
    torch.cuda.empty_cache()
    return per_forward


def path_engine(name: str, dev):
    """The engine of serving path ``name`` as ``main`` builds it from its
    seeded synthetic artifact: DeiT-S at sm8 + stable GELU by the
    default kernels (``main``) or with ``strict_dyadic`` (``strict``), at
    sm16 + row-max GELU by route ``A`` or ``B``, or Swin-T (``swin``)."""
    from ivit_tpu_torch.deploy import build_swin_infer, build_vit_infer, synthetic_swin_artifact
    from ivit_tpu_torch.deploy import synthetic_vit_artifact

    if name == "swin":
        return build_swin_infer(synthetic_swin_artifact("swin_tiny", seed=SEED), dev)
    sm8 = name in ("main", "strict")
    art = synthetic_vit_artifact("deit_small", seed=SEED, softmax_bits=8 if sm8 else 16, gelu_stable=sm8)
    if name == "strict":
        return build_vit_infer(art, dev, kernels=(), strict_dyadic=True)
    return build_vit_infer(art, dev) if name == "main" else build_vit_infer(art, dev, kernels={"A": ROUTE_A,
                                                                                                "B": ROUTE_B}[name])


def export_file(task: tuple) -> tuple:
    """Phase 11's export in a spawned worker: ``task`` is (path name,
    batch, file, device); builds the path's engine on the device
    (``path_engine``), writes it to the file by ``deploy.export_engine``
    and returns (bytes, seconds of the export)."""
    import torch

    sys.path.insert(0, REPO)
    from ivit_tpu_torch.deploy.export import export_engine

    name, batch, path, device = task
    fn = path_engine(name, torch.device(device))
    t0 = time.perf_counter()
    size = len(export_engine(fn, batch, fn.tensors["config"]["img_size"], path=path))
    return size, time.perf_counter() - t0


def remat_phase(dev) -> None:
    """Phase 11 (a): ViT-L and Swin-B QAT steps with ``remat`` (module
    docstring)."""
    import numpy as np
    import torch

    from ivit_tpu_torch.models import create_model
    from ivit_tpu_torch.train import AdamW, create_train_state, make_train_step, soft_target_cross_entropy

    rng = np.random.default_rng(SEED + 11)

    for name, fit_batch in REMAT_MODELS.items():
        t_model = time.perf_counter()
        model = create_model(name, dev, seed=SEED, drop_path_rate=TRAIN_DROP_PATH)
        init = {k: v.clone() for k, v in model.state_dict().items()}
        size, classes = model.config["img_size"], model.config["num_classes"]

        def batch(n: int):
            """Seeded normal images and label-smoothed one-hot targets, on the card."""
            x = rng.standard_normal((n, size, size, 3), dtype=np.float32)
            t = np.full((n, classes), TRAIN_SMOOTHING / classes, np.float32)
            t[np.arange(n), rng.integers(0, classes, n)] += 1.0 - TRAIN_SMOOTHING
            return torch.from_numpy(x).to(dev), torch.from_numpy(t).to(dev)

        # step 1 with and without the recompute, from the same weights and
        # the same generator seed
        x, t = batch(REMAT_CMP_BATCH)
        runs = []
        for remat in (False, True):
            model.load_state_dict(init)
            model.remat = remat
            gen = torch.Generator(device=dev).manual_seed(SEED)
            names, params = zip(*model.named_parameters())
            logits = model(x, train=True, generator=gen)
            grads = torch.autograd.grad(soft_target_cross_entropy(logits, t), params, materialize_grads=True)
            runs.append((logits.detach(), {n: b.clone() for n, b in model.named_buffers()},
                         dict(zip(names, grads)), gen.get_state()))
            del logits, grads
        (l0, b0, g0, s0), (l1, b1, g1, s1) = runs
        ranges_equal = all(torch.equal(b1[n], b0[n]) for n in b0)
        grad_errs = {n: float((g1[n] - g0[n]).abs().max()) / max(float(g0[n].abs().max()), 1e-30) for n in g0}
        worst = max(grad_errs, key=grad_errs.get)
        exact = sum(torch.equal(g1[n], g0[n]) for n in g0)
        print(f"remat {name}, step 1 at batch {REMAT_CMP_BATCH}, drop-path {TRAIN_DROP_PATH}, with against without "
              f"the recompute: logits max_abs_err {float((l1 - l0).abs().max())}, {len(b0)} ranges equal "
              f"{ranges_equal} (tolerance 0); gradients bit-equal in {exact} of {len(g0)} leaves, the largest error "
              f"{grad_errs[worst]} of its leaf's largest entry ({worst}; bound {QAT_GRAD_RTOL}); the generator's "
              f"state equal {torch.equal(s0, s1)}")
        check(torch.equal(l1, l0), f"remat {name}: the logits differ from the step without the recompute")
        check(ranges_equal, f"remat {name}: the ranges differ from the step without the recompute")
        check(grad_errs[worst] <= QAT_GRAD_RTOL, f"remat {name}: gradient {worst} off by {grad_errs[worst]}")
        check(torch.equal(s0, s1), f"remat {name}: the generator ends elsewhere than without the recompute")
        del runs, l0, l1, b0, b1, g0, g1

        # timed steps (AdamW, the EMA, drop-path from a seeded generator):
        # both ways at the batch both fit, then at 128 with the recompute
        steps = {}
        for remat, b in ((False, fit_batch), (True, fit_batch), (True, REMAT_BATCH)):
            model.load_state_dict(init)
            model.remat = remat
            state = create_train_state(model, AdamW(TRAIN_LR, weight_decay=TRAIN_WD), ema_decay=TRAIN_EMA, device=dev)
            step = make_train_step(model, ema_decay=TRAIN_EMA)
            gen = torch.Generator(device=dev).manual_seed(SEED)
            batches = [batch(b) for _ in range(REMAT_STEPS + 1)]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            losses = [step(state, *batches[0], gen)[1]["loss"]]  # the warm-up step
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for xb, tb in batches[1:]:
                losses.append(step(state, xb, tb, gen)[1]["loss"])
            end.record()
            end.synchronize()
            ms, peak = start.elapsed_time(end) / REMAT_STEPS, torch.cuda.max_memory_allocated(dev)
            losses = [v.item() for v in losses]
            steps[(remat, b)] = ms
            print(f"remat {name}: remat={remat} batch {b}: {ms} ms/step, {b * 1000 / ms} images/s over {REMAT_STEPS} "
                  f"steps after a warm-up step (CUDA events); max_memory_allocated {peak} bytes ({peak / 1e9:.3f} GB); "
                  f"losses {losses}")
            check(all(math.isfinite(v) for v in losses), f"remat {name} batch {b}: a non-finite loss {losses}")
            del state, step, batches
            torch.cuda.empty_cache()
        print(f"remat {name}: step time with/without the recompute at batch {fit_batch}: "
              f"{steps[(True, fit_batch)] / steps[(False, fit_batch)]}; phase {time.perf_counter() - t_model:.3f} s")
        del model, init
        torch.cuda.empty_cache()


def export_phase(dev, paths: dict, images) -> None:
    """Phase 11 (b)-(d): every path exported at batch 128 and 1, reloaded
    in a fresh process and in this one, eager and graphed beside the live
    engine; the host µs a wrapper call (module docstring). ``paths``:
    name → (live engine, its launches a forward), each engine
    ``path_engine(name)`` builds; ``images`` the batch-128 CPU images.
    The exports run in EXPORT_WORKERS spawned processes, each building
    its path's engine anew, the longest (strict mode's) first."""
    import multiprocessing

    import numpy as np
    import torch

    from ivit_tpu_torch import kernels
    from ivit_tpu_torch.deploy.export import load_engine
    from ivit_tpu_torch.deploy.graphs import capture_infer
    from ivit_tpu_torch.kernels import WRAPPERS

    images_dev = images.to(dev)
    img = images.shape[1]
    live = {name: fn(images_dev) for name, (fn, _) in paths.items()}
    with tempfile.TemporaryDirectory() as tmp:
        np.save(os.path.join(tmp, "images.npy"), images.numpy())
        files = {(name, b): os.path.join(tmp, f"{name}_b{b}.pt2") for name in paths for b in (BATCH, 1)}
        tasks = sorted(((name, b, path, str(dev)) for (name, b), path in files.items()),
                       key=lambda task: (task[0] != "strict", task[0] != "swin", -task[1]))
        t0 = time.perf_counter()
        with multiprocessing.get_context("spawn").Pool(EXPORT_WORKERS) as pool:
            exported = pool.map(export_file, tasks, chunksize=1)
        for (name, b, _, _), (size, seconds) in zip(tasks, exported):
            print(f"export {name} batch {b}: {size} bytes ({size / 1e6:.3f} MB) in {seconds:.3f} s")
        print(f"exports: {len(tasks)} files by {EXPORT_WORKERS} processes in {time.perf_counter() - t0:.3f} s")

        # (b) every file reloaded in a fresh process that builds no engine
        t0 = time.perf_counter()
        run = subprocess.run([sys.executable, os.path.join(REPO, "scripts", "torch_reload_engine.py"),
                              os.path.join(tmp, "images.npy"), *files.values()],
                             cwd=REPO, capture_output=True, text=True, timeout=600)
        print(f"reload: scripts/torch_reload_engine.py exit {run.returncode} in {time.perf_counter() - t0:.1f} s")
        for line in run.stderr.strip().splitlines()[-6:]:
            print(f"  stderr: {line}")
        check(run.returncode == 0, f"reload: exit {run.returncode}")
        lines = [json.loads(line) for line in run.stdout.strip().splitlines()]
        check(len(lines) == len(files), f"reload: {len(lines)} lines for {len(files)} engines")
        for ((name, b), path), line in zip(files.items(), lines):
            got = torch.from_numpy(np.load(path + ".logits.npy"))
            want = live[name][:b].cpu()
            e = float((got - want).abs().max())
            print(f"reload {name} batch {b}: launches a forward {line['launches']} (device {line['device']}); logits "
                  f"vs the live engine max_abs_err {e} (tolerance 0)")
            check(line["launches"] == paths[name][1], f"reload {name} batch {b}: launches {line['launches']}")
            check(torch.equal(got, want), f"reload {name} batch {b}: differs from the live engine")

        # (c) reloaded here: eager and graphed beside the live engine, in
        # turns (live, reloaded, reloaded, live)
        def host_ms(fn, x, runs: int = EXPORT_RUNS) -> float:
            lat = []
            for i in range(runs + 5):
                t1 = time.perf_counter()
                fn(x)
                torch.cuda.synchronize()
                if i >= 5:
                    lat.append((time.perf_counter() - t1) * 1e3)
            return sorted(lat)[len(lat) // 2]

        for (name, b), path in files.items():
            if name not in TIMED_EXPORTS:
                continue
            fn, per_forward = paths[name]
            engine = load_engine(path)
            x = images_dev[:b]
            check(torch.equal(engine(x), live[name][:b]), f"reloaded {name} batch {b}: differs from the live engine")
            graphs = {"live": capture_infer(fn, b, img, dev), "reloaded": capture_infer(engine, b, img, dev)}
            check(graphs["reloaded"].launches == per_forward,
                  f"reloaded {name} batch {b}: {graphs['reloaded'].launches} launches a captured forward")
            check(torch.equal(graphs["reloaded"](x), live[name][:b]), f"reloaded {name} batch {b}: replay differs")
            eager = {"live": fn, "reloaded": engine}
            row = {}
            for way, fns in (("eager", eager), ("graphed", graphs)):
                if b == BATCH:
                    t = [cuda_ms(lambda: fns[k](x), EXPORT_ITERS) for k in ("live", "reloaded", "reloaded", "live")]
                    row[way] = (BATCH / ((t[0] + t[3]) / 2) * 1e3, BATCH / ((t[1] + t[2]) / 2) * 1e3)
                else:
                    t = [host_ms(fns[k], x) for k in ("live", "reloaded", "reloaded", "live")]
                    row[way] = ((t[0] + t[3]) / 2, (t[1] + t[2]) / 2)
            unit = (f"images/s (CUDA events over {EXPORT_ITERS} forwards)" if b == BATCH
                    else f"ms/image (host clock, median of {EXPORT_RUNS})")
            print(f"reloaded {name} batch {b}: eager live {row['eager'][0]}, reloaded {row['eager'][1]}; graphed live "
                  f"{row['graphed'][0]}, reloaded {row['graphed'][1]} {unit}; reloaded/live graphed "
                  f"{row['graphed'][1] / row['graphed'][0]}")
            del engine, graphs, eager
            torch.cuda.empty_cache()

    # (d) the host µs a wrapper call, at the paths' batch-128 shapes
    calls = wrapper_calls(kernels, dev)
    us = {name: host_us(fn) for name, fn in calls.items()}
    print(f"host us a wrapper call (through its ivit:: operator; {HOST_CALLS} calls queued behind a spin kernel): {us}")
    check(set(us) == set(WRAPPERS), f"host us: {sorted(us)}")


# 12. multi-GPU on the one card: a world of one over nccl through torchrun,
# then MESH_RANKS ranks sharing cuda:0 over a gloo group named explicitly
MESH_RANKS = 2
MESH_LABEL = f"{MESH_RANKS} ranks on one H100, gloo (collectives through the host); not a scaling figure"
MESH_CLI = ["--model", "deit_small", "--batch-size", "32", "--max-steps-per-epoch", "2", "--epochs", "1"]
MESH_EVAL_BATCH = 64
MESH_QAT_BATCH = 64  # global: MESH_QAT_BATCH / MESH_RANKS rows a rank
MESH_QAT_STEPS = 2
# the QAT step of tests/test_torch_parallel_train.py and its stated bounds
# after the first step: the loss within MESH_LOSS_ULPS, each parameter
# within 1e-3·lr where its gradient (the first moment, 0.1·g) is at least
# 1e-2 of its leaf's largest, else within Adam's bound of 3·lr (a gradient
# near eps: its rounding moves the update)
MESH_LR, MESH_WD, MESH_EMA, MESH_CLIP = 1e-3, 0.05, 0.9, 1.0
MESH_LOSS_ULPS = 4
MESH_PARAM_ATOL, MESH_SMALL_GRAD, MESH_ADAM_ATOL = 1e-3 * MESH_LR, 1e-2, 3 * MESH_LR


def torchrun(args: list, nproc: int, timeout: int) -> list:
    """``python -m torch.distributed.run --standalone --nproc-per-node
    nproc -m <args>`` from the repository root, as a user launches it;
    prints its output and fails unless it exits 0."""
    return run_cli(["torch.distributed.run", "--standalone", f"--nproc-per-node={nproc}", "-m", *args], timeout)


def flat_state(path: str) -> dict:
    from ivit_tpu_torch.nn.flax_state import flatten
    from ivit_tpu_torch.utils import load_checkpoint_raw

    state, extra = load_checkpoint_raw(path)
    return {**flatten(state), **{f"extra.{k}": v for k, v in extra.items()}}


def nccl_world_of_one(dev) -> None:
    """Phase 12 (a): ``quant_train --distributed --zero1`` under torchrun
    with one rank (nccl) against the same run without ``--distributed``
    (every checkpoint leaf equal), then ``evaluate_accuracy --mesh-data
    1`` under torchrun on the converted result against the
    single-process sweep (logits equal, 12 K1 + 25 K3 a captured
    forward)."""
    import numpy as np

    from ivit_tpu_torch import convert_model, evaluate_accuracy, quant_train

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        d1, d0 = os.path.join(tmp, "dist"), os.path.join(tmp, "single")
        train = [*CLI_TRAIN, *MESH_CLI]
        lines = torchrun(["ivit_tpu_torch.quant_train", *train, "--distributed", "--zero1", "--output-dir", d1], 1, 400)
        check(any("1 ranks over nccl" in line for line in lines + open(os.path.join(d1, "log.log")).read().splitlines()),
              "quant_train --distributed: not one nccl rank")
        quant_train.main([*train, "--device", str(dev), "--output-dir", d0])
        got, want = flat_state(os.path.join(d1, "checkpoint.pkl")), flat_state(os.path.join(d0, "checkpoint.pkl"))
        differ = [k for k in want if not np.array_equal(np.asarray(got.get(k)), np.asarray(want[k]))]
        print(f"nccl world of one: quant_train --distributed --zero1 ({' '.join(MESH_CLI)}) checkpoint against the "
              f"run without --distributed: {len(want)} leaves, {len(differ)} differ {differ[:5]} (tolerance 0)")
        check(got.keys() == want.keys() and not differ, "nccl world of one: the checkpoint differs")
        art, e1, e0 = (os.path.join(tmp, f) for f in ("artifact.pkl", "e1.npz", "e0.npz"))
        convert_model.main(["--checkpoint", os.path.join(d1, "checkpoint.pkl"), "--output", art, "--device", str(dev)])
        ev = ["--model", "deit_small", "--artifact", art, *CLI_EVAL, "--batch-size", str(MESH_EVAL_BATCH),
              "--max-batches", "1"]
        lines = torchrun(["ivit_tpu_torch.evaluate_accuracy", *ev, "--mesh-data", "1", "--dump-logits", e1], 1, 300)
        evaluate_accuracy.main([*ev, "--device", str(dev), "--dump-logits", e0])
        captured = re.search(r"launches a forward (\{.*\})", "\n".join(lines))
        a, b = np.load(e1), np.load(e0)
        same = np.array_equal(a["logits"], b["logits"]) and np.array_equal(a["labels"], b["labels"])
        print(f"nccl world of one: evaluate_accuracy --mesh-data 1 logits {a['logits'].shape} equal to the "
              f"single-process sweep {same}; launches a forward {captured and captured.group(1)}")
        check(any("over nccl" in line for line in lines), "evaluate_accuracy --mesh-data 1: not over nccl")
        check(same, "evaluate_accuracy --mesh-data 1 differs from the single-process sweep")
        check(captured is not None and ast.literal_eval(captured.group(1)) == {"K1": 12, "K3": 25},
              f"evaluate_accuracy --mesh-data 1: launches {captured and captured.group(1)}")
    print(f"nccl world of one: {time.perf_counter() - t0:.3f} s")


def rank_kernel(kernels: dict, rank: int, name: str, shape: str, fn, ref, args: tuple, bound: tuple) -> None:
    """One kernel of a rank against its plain version on the rank's own
    inputs (``kernels[name]``: the largest difference, and on rank 0,
    while the other ranks wait, its time beside the plain version's and
    its bound). Every rank of the default group calls it in turn; with
    ``rank`` None one process calls it alone."""
    import torch
    import torch.distributed as dist

    got, want = fn(*args), ref(*args)
    pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]  # K6: (hi, lo)
    err = max(max_abs_err(a, b) for a, b in pairs)
    torch.cuda.synchronize()
    if rank is not None:
        dist.barrier()
    k_ms = p_ms = q_ms = None
    if not rank:  # rank 0, or a caller alone (rank None)
        k_ms, p_ms, q_ms = paired_ms(lambda: fn(*args), lambda: ref(*args), 10)
    if rank is not None:
        dist.barrier()
    kernels[name] = {"shape": shape, "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms, "queued_ms": q_ms,
                     "bound_ms": bound[0], "bound_by": bound[1]}


def tp_vit_kernels(kernels: dict, rank: int, infer, images, suffix: str = "") -> None:
    """K3 on block 0's full rows and K1 (sm8) on this rank's heads of a
    tensor-parallel ViT engine (``shard_infer_tp``), or on every head of a
    single-process one, each by ``rank_kernel``."""
    from ivit_tpu_torch.deploy.engine import attention_inputs, embed
    from ivit_tpu_torch.kernels import (
        fused_int8_attention,
        fused_int8_attention_reference,
        fused_layernorm_requant,
        fused_layernorm_requant_reference,
    )

    t, cfg = infer.tensors, infer.tensors["config"]
    D, N = cfg["embed_dim"], (cfg["img_size"] // cfg["patch_size"]) ** 2 + 1
    x = embed(images, t)
    blk = t["blocks"][0]
    rows = x.reshape(-1, D)
    M = rows.shape[0]
    rank_kernel(kernels, rank, "K3" + suffix, f"({M}, {D}) full rows", fused_layernorm_requant,
                fused_layernorm_requant_reference, (rows, blk["norm1"]["bias_int"], blk["norm1"]["ratio"]),
                bound_ms(M * D * 3 + 8 * D, elementwise=per_element(M * D, LAYERNORM_OPS)))
    heads = blk.get("heads", cfg["num_heads"])
    q, k, v = attention_inputs(x, blk, heads)
    a, (G, _, hd) = blk["attn"], q.shape
    rank_kernel(kernels, rank, "K1" + suffix, f"({G}, {N}, {hd}) sm8, {heads} of {cfg['num_heads']} heads",
                fused_int8_attention, fused_int8_attention_reference, (q, k, v, a["r1"], a["scale"], a["r_out"], 8),
                bound_ms(4 * G * N * hd, int8_ops=2 * G * N * N * hd * 2,
                         elementwise=per_element(G * N * N, ATTN_TABLE_OPS)))


def tp_swin_kernels(kernels: dict, rank: int, infer, images, suffix: str = "") -> None:
    """K7 on each stage's first block of a tensor-parallel Swin engine,
    on this rank's heads (a stage the model axis leaves whole on all of
    them), each by ``rank_kernel``; the trunk runs the blocks'
    collectives."""
    from ivit_tpu_torch.deploy.swin_engine import patch_embed, swin_trunk, window_attention_inputs
    from ivit_tpu_torch.kernels import fused_int8_window_attention, fused_int8_window_attention_reference

    ts = infer.tensors
    firsts = {id(stage["blocks"][0]): i for i, stage in enumerate(ts["stages"])}
    seen = {}

    def visit(layer, x):
        if id(layer) in firsts:
            seen[firsts[id(layer)]] = (layer, window_attention_inputs(x, layer, kernels=()))

    swin_trunk(patch_embed(images, ts), ts, infer.kernels, on_layer=visit)
    full_heads = ts["config"]["num_heads"]
    for i in sorted(seen):
        layer, (q, k, v) = seen[i]
        a, heads = layer["attn"], layer["heads"]
        G, Nw, hdw = q.shape
        rank_kernel(kernels, rank, f"K7 stage {i + 1}{suffix}", f"({G}, {Nw}, {hdw}), {heads} of {full_heads[i]} heads"
                    + (" (replicated)" if heads == full_heads[i] else ""),
                    fused_int8_window_attention, fused_int8_window_attention_reference,
                    (q, k, v, a["bias"], a["mask"], a["r1"], a["rb"], a["scale"], a["r_out"], heads),
                    bound_ms(4 * G * Nw * hdw + 4 * heads * Nw * Nw, int8_ops=4 * G * Nw * Nw * hdw,
                             elementwise=per_element(G * Nw * Nw, WINDOW_TABLE_OPS)))


def mesh_rank(rank: int, world: int, init_file: str, work: str) -> None:
    """Phase 12 (b), one rank of MESH_RANKS on cuda:0 over gloo: the
    sharded engines against the single-process logits (in
    ``work/inputs.pkl``) with each forward's launches, the kernels on
    this rank's inputs against their plain versions (timed on rank 0
    while the other ranks wait), and the data-parallel QAT steps against
    the single-process step; writes ``work/rank<r>.pkl``."""
    import pickle

    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, REPO)
    from ivit_tpu_torch.deploy import build_swin_infer, build_vit_infer
    from ivit_tpu_torch.deploy.engine import _layernorm, attention_half, attention_inputs, embed, int8_linear
    from ivit_tpu_torch.kernels import (
        WRAPPERS,
        fused_requant_shiftgelu,
        fused_requant_shiftgelu_reference,
        fused_requant_shiftmax,
        fused_requant_shiftmax_reference,
    )
    from ivit_tpu_torch.models import create_model
    from ivit_tpu_torch.parallel import init_distributed, make_mesh, shard_infer, shard_infer_tp, shard_train_state
    from ivit_tpu_torch.parallel import gather_train_state
    from ivit_tpu_torch.train import AdamW, MixupConfig, create_train_state, make_train_step, mixup_cutmix

    joined = init_distributed(backend="gloo", device="cuda", init_method=f"file://{init_file}", rank=rank,
                              world_size=world)
    dev = joined.device
    with open(os.path.join(work, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    images = torch.from_numpy(inp["images"]).to(dev)
    dp, tp = make_mesh(world, 1), make_mesh(1, world)
    out = {"device": str(dev), "backend": joined.backend, "paths": {}, "kernels": {}}

    def drive(label, fn, x, ref):
        torch.cuda.synchronize()
        dist.barrier()
        for w in WRAPPERS.values():
            w.launches = 0
        t0 = time.perf_counter()
        y = fn(x)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        y = y.cpu()
        out["paths"][label] = {"equal": torch.equal(y, ref), "max_abs_err": float((y - ref).abs().max()),
                               "launches": {k: w.launches for k, w in WRAPPERS.items() if w.launches}, "ms": ms}

    main_tp = shard_infer_tp(inp["art8"], tp)
    b_tp = shard_infer_tp(inp["art16"], tp, kernels=ROUTE_B)
    swin_tp = shard_infer_tp(inp["swin"], tp, build_fn=build_swin_infer)
    main_tp(images[:1])  # loads the kernels in this process
    drive("main DP=2 batch 128", shard_infer(build_vit_infer(inp["art8"], dev), dp), images, inp["ref"]["main"])
    drive("main TP=2 batch 128", main_tp, images, inp["ref"]["main"])
    drive("main TP=2 batch 1", main_tp, images[:1], inp["ref"]["main"][:1])
    drive("B TP=2 batch 128", b_tp, images, inp["ref"]["B"])
    drive("swin TP=2 batch 128", swin_tp, images, inp["ref"]["swin"])
    try:
        shard_infer_tp(inp["art16"], tp, kernels=ROUTE_A)
        out["k4_raises"] = None
    except ValueError as e:
        out["k4_raises"] = str(e)

    def kernel(*args):
        rank_kernel(out["kernels"], rank, *args)

    with torch.inference_mode():
        tp_vit_kernels(out["kernels"], rank, main_tp, images)
        t, cfg = main_tp.tensors, main_tp.tensors["config"]
        D, N = cfg["embed_dim"], (cfg["img_size"] // cfg["patch_size"]) ** 2 + 1
        hidden = int(D * cfg["mlp_ratio"])
        M = images.shape[0] * N
        tb = b_tp.tensors
        xb = embed(images, tb)
        blkb = tb["blocks"][0]
        q, k, v = attention_inputs(xb, blkb, blkb["heads"], b_tp.kernels)
        scores = torch.matmul(q.to(torch.float64), k.to(torch.float64).transpose(-1, -2)).to(torch.int32)
        scores = scores.view(-1, N)
        a = blkb["attn"]
        kernel("K6", f"({scores.shape[0]}, {N}) out_bits 16, {blkb['heads']} heads", fused_requant_shiftmax,
               fused_requant_shiftmax_reference, (scores, a["r1"], a["scale"], N),
               bound_ms(scores.numel() * 6, elementwise=per_element(scores.numel(), K6_TABLE_OPS)))
        h = attention_half(xb, blkb, tb["config"], b_tp.kernels)  # proj's all-reduce
        acc = int8_linear(_layernorm(h, blkb["norm2"], b_tp.kernels), blkb["fc1"])  # fc1's all-gather
        fc1, gelu = blkb["fc1"], blkb["gelu"]
        kernel("K5", f"({acc.shape[0]}, {acc.shape[1]}) gathered rows", fused_requant_shiftgelu,
               fused_requant_shiftgelu_reference, (acc, fc1["ratio"], gelu["s_in"], gelu["r2"]),
               bound_ms(M * hidden * 5 + 4 * hidden + 256 * 256, elementwise=per_element(M * hidden, K5_TABLE_OPS)))
        tp_swin_kernels(out["kernels"], rank, swin_tp, images)
    del main_tp, b_tp, swin_tp, t, tb, xb, h, acc, scores
    torch.cuda.empty_cache()

    # the QAT steps: the same global batches on every rank (mixup/cutmix on
    # the card from the same draws), split by the step
    batches = []
    for i in range(MESH_QAT_STEPS):
        rng = np.random.default_rng((SEED, 12, i))
        xq = torch.from_numpy(rng.standard_normal((MESH_QAT_BATCH, 224, 224, 3), dtype=np.float32))
        labels = torch.from_numpy(rng.integers(0, 1000, MESH_QAT_BATCH))
        batches.append(mixup_cutmix(xq, labels, MixupConfig(), np.random.default_rng((SEED, 12, i, 1)), device=dev))

    def qat(mesh, zero1):
        model = create_model("deit_small", dev, seed=SEED, drop_path_rate=TRAIN_DROP_PATH)
        state = create_train_state(model, AdamW(MESH_LR, weight_decay=MESH_WD), ema_decay=MESH_EMA, device=dev)
        if zero1:
            state = shard_train_state(state, mesh)
        step = make_train_step(model, ema_decay=MESH_EMA, grad_clip=MESH_CLIP, mesh=mesh)
        seen_logits = []
        hook = model.register_forward_hook(lambda m, args, o: seen_logits.append(o.detach()))
        rec = {"logits": [], "ranges": [], "loss": [], "ms": []}
        for i, (xq, tq) in enumerate(batches):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, met = step(state, xq, tq, torch.Generator(device=dev).manual_seed(1000 + i))
            loss = float(met["loss"])
            rec["ms"].append((time.perf_counter() - t0) * 1e3)
            logits = seen_logits[-1] if mesh is None else mesh.all_gather(seen_logits[-1], "data")
            rec["logits"].append(logits.cpu())
            rec["ranges"].append({n: b.cpu().clone() for n, b in model.named_buffers()})
            rec["loss"].append(loss)
            if i == 0:  # the parameters after the first step, and the first moment (0.1·g) of a whole state
                rec["params1"] = {n: p.detach().clone() for n, p in model.named_parameters()}
                rec["mu1"] = None if state.zero1 else dict(zip(rec["params1"], [m.clone() for m in state.opt_state.mu]))
        hook.remove()
        local = list(state.opt_state.mu) + list(state.opt_state.nu) + list((state.ema_params or {}).values())
        rec["opt_bytes"] = sum(tq.numel() * tq.element_size() for tq in local)
        whole = gather_train_state(state)
        names = [n for n, _ in model.named_parameters()]
        rec["params"] = {n: p.detach().clone() for n, p in model.named_parameters()}
        rec["mu"] = dict(zip(names, whole.opt_state.mu))
        rec["nu"] = dict(zip(names, whole.opt_state.nu))
        rec["ema"] = dict(whole.ema_params)
        return rec

    single = qat(None, False) if rank == 0 else None
    dist.barrier()
    shared = [None if single is None else {k: single[k] for k in ("logits", "ranges", "loss")}]
    dist.broadcast_object_list(shared, src=0)
    ref = shared[0]
    runs = {"DP": qat(dp, False), "DP + ZeRO-1": qat(dp, True)}
    res = {"loss": {k: r["loss"] for k, r in runs.items()}, "single_loss": ref["loss"],
           "opt_bytes": {k: r["opt_bytes"] for k, r in runs.items()}, "ms": {k: r["ms"] for k, r in runs.items()}}
    d, z = runs["DP"], runs["DP + ZeRO-1"]
    # step 1 runs both on the same parameters: its logits and ranges are
    # equal by design; later steps run on parameters the all-reduce's
    # rounding has moved, and are printed
    res["logits_max_abs_err"] = [float((a - b).abs().max()) for a, b in zip(d["logits"], ref["logits"])]
    res["ranges_differ"] = [sum(not torch.equal(a[n], b[n]) for n in b) for a, b in zip(d["ranges"], ref["ranges"])]
    res["loss_ulps"] = [float(abs(np.float32(a) - np.float32(b)) / np.spacing(np.abs(np.float32(b))))
                        for a, b in zip(d["loss"], ref["loss"])]
    res["zero1_equal_dp"] = (d["loss"] == z["loss"] and all(torch.equal(a, b) for a, b in zip(d["logits"], z["logits"]))
                             and all(torch.equal(d[key][n], z[key][n]) for key in ("params", "mu", "nu", "ema")
                                     for n in d[key]))
    sums = torch.stack([p.double().sum() for p in d["params"].values()])
    res["ranks_agree"] = bool(torch.equal(dp.all_gather(sums[None], "data")[0], dp.all_gather(sums[None], "data")[-1]))
    if single is not None:
        worst, errs = 0.0, 0
        for n, p in single["params1"].items():
            m = single["mu1"][n].abs()
            atol = torch.where(m >= MESH_SMALL_GRAD * m.max(), MESH_PARAM_ATOL, MESH_ADAM_ATOL)
            diff = (d["params1"][n] - p).abs()
            worst = max(worst, float(diff.max()))
            errs += int((diff > atol + 2.0**-22 * p.abs()).sum())
        res["param_max_abs_err"], res["params_outside"] = worst, errs
    out["qat"] = res
    with open(os.path.join(work, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


def mesh_phase(smi: str, inputs: dict) -> dict:
    """Phase 12 (b) (``mesh_rank`` on MESH_RANKS spawned ranks): prints
    and checks each rank's results; returns rank 0's kernel entries."""
    import pickle

    import torch.multiprocessing as mp

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as work:
        with open(os.path.join(work, "inputs.pkl"), "wb") as f:
            pickle.dump(inputs, f)
        mp.start_processes(mesh_rank, args=(MESH_RANKS, os.path.join(work, "rendezvous"), work), nprocs=MESH_RANKS,
                           join=True, start_method="spawn")
        ranks = []
        for r in range(MESH_RANKS):
            with open(os.path.join(work, f"rank{r}.pkl"), "rb") as f:
                ranks.append(pickle.load(f))
    print(f"phase 12 mesh: {MESH_LABEL}; {smi}")
    depth, layernorms = 12, 25
    main = {"K1": depth, "K3": layernorms, "K9": depth}  # K9 on each rank's fc1 columns under TP
    expect = {"main DP=2 batch 128": main, "main TP=2 batch 128": main, "main TP=2 batch 1": main,
              "B TP=2 batch 128": {"K6": depth, "K5": depth, "K3": layernorms},
              "swin TP=2 batch 128": {"K7": 12, "K3": 28}}
    for r, res in enumerate(ranks):
        check(res["device"] == "cuda:0" and res["backend"] == "gloo", f"rank {r}: {res['device']} {res['backend']}")
        for label, p in res["paths"].items():
            print(f"rank {r} {label}: logits vs the single-process engine max_abs_err {p['max_abs_err']} (tolerance 0); "
                  f"launches {p['launches']}; {p['ms']:.3f} ms a forward, host clock ({MESH_LABEL})")
            check(p["equal"], f"rank {r} {label}: logits differ from the single-process engine")
            check(p["launches"] == expect[label], f"rank {r} {label}: launches {p['launches']}, expected {expect[label]}")
        print(f"rank {r}: K4 (linear_gelu) under model=2 raises ValueError: {res['k4_raises']!r}")
        check(bool(res["k4_raises"]), f"rank {r}: K4 under TP did not raise")
        for name, kr in res["kernels"].items():
            timing = "" if kr["ms"] is None else (f"; kernel {kr['ms']} ms (queued {kr['queued_ms']} ms), plain "
                                                  f"{kr['plain_ms']} ms, bound {kr['bound_ms']} ms ({kr['bound_by']})")
            print(f"rank {r} {name} on this rank's inputs {kr['shape']}: max_abs_err {kr['max_abs_err']} "
                  f"(tolerance 0){timing}")
            check(kr["max_abs_err"] == 0, f"rank {r} {name}: differs from its plain version")
        q = res["qat"]
        print(f"rank {r} QAT DeiT-S, global batch {MESH_QAT_BATCH}, {MESH_QAT_STEPS} steps (drop path "
              f"{TRAIN_DROP_PATH}, mixup/cutmix), DP against the single-process step by step: ranges that differ "
              f"{q['ranges_differ']}, logits max_abs_err {q['logits_max_abs_err']} (step 1: tolerance 0); loss "
              f"{q['loss']} vs {q['single_loss']} ({q['loss_ulps']} ulps; step 1 bound {MESH_LOSS_ULPS}); ZeRO-1 "
              f"equal to DP (params, moments, EMA, logits, loss) {q['zero1_equal_dp']}; ranks agree "
              f"{q['ranks_agree']}; optimizer-state bytes a rank {q['opt_bytes']}; ms a step {q['ms']} ({MESH_LABEL})")
        check(q["ranges_differ"][0] == 0 and q["logits_max_abs_err"][0] == 0,
              f"rank {r}: DP step 1 ranges or logits differ from the single-process step")
        check(q["loss_ulps"][0] <= MESH_LOSS_ULPS, f"rank {r}: DP step 1 loss off by {q['loss_ulps'][0]} ulps")
        check(q["zero1_equal_dp"] and q["ranks_agree"], f"rank {r}: ZeRO-1 differs from DP, or the ranks differ")
        check(q["opt_bytes"]["DP + ZeRO-1"] < q["opt_bytes"]["DP"], f"rank {r}: ZeRO-1 holds no less state")
        if "param_max_abs_err" in q:
            print(f"rank {r} QAT: parameters after step 1 vs the single-process step: max_abs_err "
                  f"{q['param_max_abs_err']}, {q['params_outside']} entries outside the bounds ({MESH_PARAM_ATOL} "
                  f"where the first moment is not small, else {MESH_ADAM_ATOL})")
            check(q["params_outside"] == 0, f"rank {r}: DP parameters outside the stated bounds")
    print(f"mesh phase: {time.perf_counter() - t0:.3f} s")
    return ranks[0]["kernels"]


# 13. tensor-parallel QAT on the one card: TPQ ranks sharing cuda:0 over
# gloo (the collectives staged through the host, as in phase 12) train
# each model at full width and depth on a (1, 2) mesh, TP and with
# sequence parallelism, then four ranks on a (2, 2) mesh with ZeRO-1 and
# remat; the TP-trained DeiT-S and Swin-T are frozen and served by
# shard_infer_tp. The step's arithmetic is phase 12's (MESH_LR, MESH_WD,
# MESH_EMA, MESH_CLIP, drop path 0.1, mixup/cutmix) at a global batch of
# TPQ_BATCH for TPQ_STEPS steps.
TPQ_LABEL = "ranks on one H100, gloo (collectives through the host); not a scaling figure"
TPQ_SIZE = 224
TPQ_BATCH = 8
TPQ_STEPS = 2
TPQ_SERVE_BATCH = 32
TPQ_GRAD_RTOL = 1e-5  # of each leaf's largest entry: the model group's float32 sums in another order
# the parameters after step 1 are held to phase 12's bounds (those of
# tests/test_torch_parallel_train.py: MESH_PARAM_ATOL where the first
# gradient is not small, MESH_ADAM_ATOL where it is). Step 2 runs on
# weights that step 1's summation order moved, and at DeiT-S's width its
# forward parts (some weights cross an int8 boundary), so the parameters
# after it are printed, not bounded
TPQ_MODELS = {"deit_small sm8 stable": ("deit_small", {"softmax_bits": 8, "gelu_stable": True}),
              "deit_small sm16 row-max": ("deit_small", {}),
              "swin_tiny": ("swin_tiny", {})}
# (mesh, {model label: {variant: flags}}, the labels served after their "TP" run)
TPQ_RUNS = (((1, 2), {"deit_small sm8 stable": {"TP": {}, "SP": {"seq": True}},
                      "deit_small sm16 row-max": {"TP": {}, "SP": {"seq": True}},
                      "swin_tiny": {"TP": {}}}, ("deit_small sm8 stable", "swin_tiny")),
            ((2, 2), {"deit_small sm16 row-max": {"TP": {}, "TP + ZeRO-1 + remat": {"zero1": True, "remat": True},
                                                  "SP + ZeRO-1 + remat": {"seq": True, "zero1": True,
                                                                          "remat": True}}}, ()))


def tpq_train(name: str, kw: dict, dev, mesh, batches: list, seq=False, zero1=False, remat=False) -> dict:
    """One QAT run of phase 13 (single-process without ``mesh``): the
    first batch's gradient whole (the ranges put back after its forward),
    then TPQ_STEPS steps, each step's logits (the global batch's) and
    ranges, the losses, the ms a step (host clock), this rank's
    optimizer-state bytes, and the whole variables after the last step,
    all on the host."""
    import torch

    from ivit_tpu_torch.models import create_model
    from ivit_tpu_torch.nn.quant import data_shard
    from ivit_tpu_torch.parallel import (
        batch_shard,
        data_mean,
        gather_train_state,
        shard_train_state,
        tensor_parallel,
    )
    from ivit_tpu_torch.train import AdamW, create_train_state, make_train_step, soft_target_cross_entropy

    model = create_model(name, dev, seed=SEED, drop_path_rate=TRAIN_DROP_PATH, remat=remat, **kw)
    state = create_train_state(model, AdamW(MESH_LR, weight_decay=MESH_WD), ema_decay=MESH_EMA, device=dev)
    if mesh is not None and mesh.shape["model"] > 1:
        tensor_parallel(state, mesh, seq_parallel=seq)
    if zero1:
        shard_train_state(state, mesh)
    rows = (lambda a: a) if mesh is None else (lambda a: mesh.block(a, "data"))
    names = [n for n, _ in model.named_parameters()]
    saved = {n: b.clone() for n, b in model.named_buffers()}
    with data_shard(None if mesh is None else batch_shard(mesh)):
        out = model(rows(batches[0][0]), train=True, generator=torch.Generator(device=dev).manual_seed(1000))
    grads = list(torch.autograd.grad(soft_target_cross_entropy(out, rows(batches[0][1])), list(model.parameters()),
                                     materialize_grads=True))
    with torch.no_grad():
        for n, b in model.named_buffers():
            b.copy_(saved[n])
        if mesh is not None:
            grads = data_mean(grads, mesh)
        if model.tp is not None:
            grads = [model.tp.join(g, n) for g, n in zip(model.tp.reduce_grads(grads, names), names)]
    rec = {"grads": {n: g.cpu() for n, g in zip(names, grads)}, "logits": [], "ranges": [], "loss": [], "ms": []}
    del out, grads
    step = make_train_step(model, ema_decay=MESH_EMA, grad_clip=MESH_CLIP, mesh=mesh)
    seen = []
    hook = model.register_forward_hook(lambda m, args, o: seen.append(o.detach()))
    for i, (x, t) in enumerate(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, met = step(state, x, t, torch.Generator(device=dev).manual_seed(1000 + i))
        rec["loss"].append(float(met["loss"]))
        rec["ms"].append((time.perf_counter() - t0) * 1e3)
        rec["logits"].append((seen[-1] if mesh is None else mesh.all_gather(seen[-1], "data")).cpu())
        rec["ranges"].append({n: b.cpu().clone() for n, b in model.named_buffers()})
        if i == 0:
            rec["params1"] = {n: p.detach().cpu().clone()
                              for n, p in gather_train_state(state).model.named_parameters()}
    hook.remove()
    local = list(state.opt_state.mu) + list(state.opt_state.nu) + list((state.ema_params or {}).values())
    rec["opt_bytes"] = sum(t.numel() * t.element_size() for t in local)
    whole = gather_train_state(state)
    rec["params"] = {n: p.detach().cpu() for n, p in whole.model.named_parameters()}
    rec["buffers"] = {n: b.cpu().clone() for n, b in whole.model.named_buffers()}
    return rec


def tpq_compare(got: dict, ref: dict) -> dict:
    """A phase-13 run against its reference run: each step's logits and
    ranges (differences), the first gradient's largest difference as a
    share of its leaf's largest entry, the step-1 loss in ulps, and the
    parameters' largest difference after step 1, with the count of
    entries outside their bound (MESH_ADAM_ATOL where the reference's
    first gradient is small, else MESH_PARAM_ATOL; 2^-22 relative), and
    after the last step."""
    import numpy as np
    import torch

    outside = 0
    for n, p in ref["params1"].items():
        g = ref["grads"][n].abs()
        atol = torch.where(g >= MESH_SMALL_GRAD * g.max(), MESH_PARAM_ATOL, MESH_ADAM_ATOL)
        outside += int(((got["params1"][n] - p).abs() > atol + 2.0**-22 * p.abs()).sum())

    return {
        "logits_max_abs_err": [float((a - b).abs().max()) for a, b in zip(got["logits"], ref["logits"])],
        "ranges_differ": [sum(not a[n].equal(b[n]) for n in b) for a, b in zip(got["ranges"], ref["ranges"])],
        "grad_rel_err": max(float((got["grads"][n] - g).abs().max() / g.abs().max().clamp_min(1e-30))
                            for n, g in ref["grads"].items()),
        "loss_ulps": float(abs(np.float32(got["loss"][0]) - np.float32(ref["loss"][0]))
                           / np.spacing(np.abs(np.float32(ref["loss"][0])))),
        "param1_max_abs_err": max(float((got["params1"][n] - p).abs().max()) for n, p in ref["params1"].items()),
        "params1_outside": outside,
        "param_max_abs_err": max(float((got["params"][n] - p).abs().max()) for n, p in ref["params"].items()),
        "equal": (all(a.equal(b) for a, b in zip(got["logits"], ref["logits"]))
                  and all(got[k][n].equal(t) for k in ("params", "grads") for n, t in ref[k].items())),
    }


def tpq_serve(label: str, name: str, kw: dict, rec: dict, mesh, images, res: dict, rank: int) -> None:
    """Freeze a TP-trained run (its whole variables in a single-process
    model) and serve it by ``shard_infer_tp`` on ``mesh``: the logits
    against the single-process engine's, the launches of one forward
    (every count set to 0 just before it and read just after), and the
    kernels on this rank's inputs against their plain versions."""
    import torch
    import torch.distributed as dist

    from ivit_tpu_torch.deploy import build_swin_infer, build_vit_infer, freeze_vit
    from ivit_tpu_torch.deploy.swin_engine import freeze_swin
    from ivit_tpu_torch.kernels import WRAPPERS
    from ivit_tpu_torch.models import create_model
    from ivit_tpu_torch.parallel import shard_infer_tp

    swin = name.startswith("swin")
    model = create_model(name, images.device, seed=SEED, **kw)
    variables = {"params": {n: p.to(images.device) for n, p in rec["params"].items()},
                 "quant_stats": {n: b.to(images.device) for n, b in rec["buffers"].items()}}
    art = (freeze_swin if swin else freeze_vit)(model, variables, images.device)
    build = build_swin_infer if swin else build_vit_infer
    with torch.inference_mode():
        single = build(art, images.device)(images).cpu()
        infer = shard_infer_tp(art, mesh, build_fn=build)
        infer(images[:1])  # loads the kernels in this process
        torch.cuda.synchronize()
        dist.barrier()
        for w in WRAPPERS.values():
            w.launches = 0
        t0 = time.perf_counter()
        logits = infer(images)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = {k: w.launches for k, w in WRAPPERS.items() if w.launches}
        kernels: dict = {}
        (tp_swin_kernels if swin else tp_vit_kernels)(kernels, rank, infer, images)
    res["serve"][label] = {"equal": torch.equal(logits.cpu(), single), "launches": launches, "ms": ms,
                           "kernels": kernels, "max_abs_err": float((logits.cpu() - single).abs().max())}


def tpq_rank(rank: int, world: int, init_file: str, work: str) -> None:
    """Phase 13, one rank of ``world`` on the card over gloo: each model
    of ``work/inputs.pkl``'s run, single-process on rank 0 (the others
    wait) and on the run's mesh in each variant, compared on rank 0;
    the frozen TP-trained models served. Writes ``work/rank<r>.pkl``."""
    import pickle

    import torch
    import torch.distributed as dist

    sys.path.insert(0, REPO)
    from ivit_tpu_torch.parallel import init_distributed, make_mesh

    with open(os.path.join(work, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    joined = init_distributed(backend="gloo", device=inp["device"], init_method=f"file://{init_file}", rank=rank,
                              world_size=world)
    dev = joined.device
    mesh_shape, runs, served = inp["run"]
    mesh = make_mesh(*mesh_shape)
    res = {"device": str(dev), "backend": joined.backend, "runs": {}, "serve": {}}
    images = torch.from_numpy(inp["serve_images"]).to(dev)
    for label, variants in runs.items():
        name, kw = TPQ_MODELS[label]
        batches = [(torch.from_numpy(x).to(dev), torch.from_numpy(t).to(dev)) for x, t in inp["batches"][name]]
        single = tpq_train(name, kw, dev, None, batches) if rank == 0 else None
        dist.barrier()
        recs = {}
        for variant, flags in variants.items():
            recs[variant] = tpq_train(name, kw, dev, mesh, batches, **flags)
            out = {"ms": recs[variant]["ms"], "opt_bytes": recs[variant]["opt_bytes"], "loss": recs[variant]["loss"]}
            if single is not None:
                out["vs_single"] = tpq_compare(recs[variant], single)
                if variant != "TP":
                    out["vs_tp"] = tpq_compare(recs[variant], recs["TP"])
            res["runs"][f"{label} {variant}"] = out
            torch.cuda.empty_cache()
        if single is not None:
            res["runs"][f"{label} single"] = {"ms": single["ms"], "opt_bytes": single["opt_bytes"],
                                             "loss": single["loss"]}
        if label in served:
            tpq_serve(label, name, kw, recs["TP"], mesh, images, res, rank)
        del single, recs
        torch.cuda.empty_cache()
    with open(os.path.join(work, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
    dist.destroy_process_group()


def tpq_phase(smi: str) -> dict:
    """Phase 13 (``tpq_rank`` on each run's ranks): prints and checks
    each rank's results; returns rank 0's kernel entries of the served
    models."""
    import pickle

    import numpy as np
    import torch
    import torch.multiprocessing as mp

    from ivit_tpu_torch.train import MixupConfig, mixup_cutmix

    t0 = time.perf_counter()
    batches = {}
    for name in ("deit_small", "swin_tiny"):
        batches[name], size = [], TPQ_SIZE
        for i in range(TPQ_STEPS):
            rng = np.random.default_rng((SEED, 13, i))
            x = torch.from_numpy(rng.standard_normal((TPQ_BATCH, size, size, 3), dtype=np.float32))
            labels = torch.from_numpy(rng.integers(0, 1000, TPQ_BATCH))
            x, t = mixup_cutmix(x, labels, MixupConfig(), np.random.default_rng((SEED, 13, i, 1)), device="cpu")
            batches[name].append((x.numpy(), t.numpy()))
    serve_images = np.random.default_rng((SEED, 13)).standard_normal((TPQ_SERVE_BATCH, TPQ_SIZE, TPQ_SIZE, 3),
                                                                     dtype=np.float32)
    kernels = {}
    for run in TPQ_RUNS:
        world = run[0][0] * run[0][1]
        with tempfile.TemporaryDirectory() as work:
            with open(os.path.join(work, "inputs.pkl"), "wb") as f:
                pickle.dump({"device": "cuda", "run": run, "batches": batches, "serve_images": serve_images}, f)
            mp.start_processes(tpq_rank, args=(world, os.path.join(work, "rendezvous"), work), nprocs=world,
                               join=True, start_method="spawn")
            ranks = []
            for r in range(world):
                with open(os.path.join(work, f"rank{r}.pkl"), "rb") as f:
                    ranks.append(pickle.load(f))
        label = f"{world} {TPQ_LABEL}; mesh (data, model) = {run[0]}"
        print(f"phase 13 tensor-parallel QAT: {label}; {smi}")
        for r, res in enumerate(ranks):
            check(res["backend"] == "gloo" and res["device"] == "cuda:0", f"rank {r}: {res['device']}")
            for key, q in res["runs"].items():
                line = f"rank {r} {key}: ms a step {q['ms']}, optimizer-state bytes {q['opt_bytes']}, loss {q['loss']}"
                for ref in ("vs_single", "vs_tp"):
                    if ref in q:
                        c = q[ref]
                        line += (f"; {ref}: logits max_abs_err by step {c['logits_max_abs_err']}, ranges that "
                                 f"differ {c['ranges_differ']} (step 1: tolerance 0), first gradient max err "
                                 f"{c['grad_rel_err']} of its leaf's largest (bound {TPQ_GRAD_RTOL}), step-1 loss "
                                 f"{c['loss_ulps']} ulps (bound {MESH_LOSS_ULPS}), parameters after step 1 "
                                 f"max_abs_err {c['param1_max_abs_err']}, {c['params1_outside']} entries outside "
                                 f"the bounds ({MESH_PARAM_ATOL} where the first gradient is not small, "
                                 f"{MESH_ADAM_ATOL} where it is), after step {TPQ_STEPS} max_abs_err "
                                 f"{c['param_max_abs_err']}")
                print(line + f" ({label})")
                for ref in ("vs_single", "vs_tp"):
                    if ref in q:
                        c = q[ref]
                        check(c["logits_max_abs_err"][0] == 0 and c["ranges_differ"][0] == 0,
                              f"rank {r} {key} {ref}: step 1 logits or ranges differ")
                        check(c["grad_rel_err"] <= TPQ_GRAD_RTOL, f"rank {r} {key} {ref}: gradient off by "
                                                                   f"{c['grad_rel_err']}")
                        check(c["loss_ulps"] <= MESH_LOSS_ULPS, f"rank {r} {key} {ref}: loss off by {c['loss_ulps']}")
                        check(c["params1_outside"] == 0, f"rank {r} {key} {ref}: {c['params1_outside']} "
                                                         f"parameters outside the bounds after step 1")
                if "ZeRO-1" in key:
                    tp_bytes = res["runs"][key.split(" TP ")[0].split(" SP ")[0] + " TP"]["opt_bytes"]
                    check(q["opt_bytes"] < tp_bytes, f"rank {r} {key}: ZeRO-1 holds no less state than TP")
                    if "TP" in key and "vs_tp" in q:
                        check(q["vs_tp"]["equal"], f"rank {r} {key}: differs from TP without ZeRO-1 and remat")
            for name, sv in res["serve"].items():
                expect = ({"K7": 12, "K3": 28} if name.startswith("swin") else
                          {"K1": 12, "K3": 25, "K9": 12} if "stable" in name else {"K1": 12, "K3": 25})
                print(f"rank {r} {name} TP-trained, frozen, served by shard_infer_tp at batch {TPQ_SERVE_BATCH}: "
                      f"logits vs the single-process engine max_abs_err {sv['max_abs_err']} (tolerance 0); launches "
                      f"{sv['launches']}; {sv['ms']:.3f} ms a forward, host clock ({label})")
                check(sv["equal"], f"rank {r} {name}: TP-served logits differ from the single-process engine")
                check(sv["launches"] == expect, f"rank {r} {name}: launches {sv['launches']}, expected {expect}")
                for kname, kr in sv["kernels"].items():
                    timing = "" if kr["ms"] is None else (
                        f"; kernel {kr['ms']} ms (queued {kr['queued_ms']} ms), plain {kr['plain_ms']} ms, bound "
                        f"{kr['bound_ms']} ms ({kr['bound_by']})")
                    print(f"rank {r} {name} {kname} on this rank's inputs {kr['shape']}: max_abs_err "
                          f"{kr['max_abs_err']} (tolerance 0){timing}")
                    check(kr["max_abs_err"] == 0, f"rank {r} {name} {kname}: differs from its plain version")
                    if r == 0:
                        kernels[kname] = dict(kr, model=name, launches=sum(v for k, v in sv["launches"].items()
                                                                           if kname.startswith(k)))
    print(f"tensor-parallel QAT phase: {time.perf_counter() - t0:.3f} s")
    return kernels


# 14. the GPipe pipeline on the one card: two ranks over gloo, a stage each
PP_LABEL = "2 ranks on one H100, gloo (activations through the host); not a scaling figure"
PP_MODEL = ("deit_small", {"softmax_bits": 8, "gelu_stable": True})  # the main path's model, full depth
PP_SIZE = 224
PP_BATCH = 8  # global; PP_MICRO microbatches of 2 rows
PP_MICRO = 4
PP_STEPS = 2
PP_SERVE_BATCH = 32
# AdamW's two moments and the EMA, float32, of a stage's parameters: the
# prologue and epilogue (patch embed, cls, pos embed, norm, head) and 6 of
# the 12 blocks
PP_STAGE_PARAMS = 757_096 + 6 * 1_774_464
PP_OPT_BYTES = 3 * 4 * PP_STAGE_PARAMS


def pp_train(model, dev, mesh, batches: list) -> dict:
    """One pipelined QAT run of phase 14 on ``mesh`` (a ``Mesh`` of one
    rank without a process group: the single-stage step): the frozen
    logits of the first batch (the global batch's), its whole gradient,
    then PP_STEPS steps' losses and ms (host clock), the whole parameters
    after step 1, this rank's optimizer-state bytes and the whole EMA
    variables after the last step, all on the host."""
    import torch

    from ivit_tpu_torch.models.model_utils import eval_variables
    from ivit_tpu_torch.parallel import (
        data_mean,
        from_pp_state,
        from_pp_variables,
        make_pp_train_step,
        pipeline_vit_forward,
        pp_gather,
        pp_rows,
        to_pp_state,
    )
    from ivit_tpu_torch.parallel.pipeline import pp_reduce_grads
    from ivit_tpu_torch.train import AdamW, create_train_state, soft_target_cross_entropy

    state = to_pp_state(create_train_state(model, AdamW(MESH_LR, weight_decay=MESH_WD), ema_decay=MESH_EMA,
                                           device=dev), mesh)
    x, t = batches[0]
    with torch.no_grad():
        logits = pp_gather(pipeline_vit_forward(model, x, mesh, PP_MICRO), mesh, PP_MICRO)
    names, params = zip(*model.named_parameters())
    loss = soft_target_cross_entropy(pipeline_vit_forward(model, x, mesh, PP_MICRO), pp_rows(t, mesh, PP_MICRO))
    grads = list(torch.autograd.grad(loss, params, materialize_grads=True))
    model.pp.wait()
    grads = data_mean(pp_reduce_grads(grads, list(names), mesh), mesh)
    grads = from_pp_variables({"params": dict(zip(names, grads))}, model.pp.depth, mesh)["params"]
    rec = {"logits": logits.cpu(), "grads": {n: g.cpu() for n, g in grads.items()}, "loss": [], "ms": []}
    del grads, loss
    step = make_pp_train_step(model, mesh, PP_MICRO, grad_clip=MESH_CLIP, ema_decay=MESH_EMA)
    for i, (x, t) in enumerate(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, met = step(state, x, t)
        rec["loss"].append(float(met["loss"]))
        rec["ms"].append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            rec["params1"] = {n: p.cpu().clone() for n, p in from_pp_state(state).model.named_parameters()}
    local = list(state.opt_state.mu) + list(state.opt_state.nu) + list(state.ema_params.values())
    rec["opt_bytes"] = sum(t.numel() * t.element_size() for t in local)
    variables = eval_variables(from_pp_state(state))
    rec["variables"] = {col: {n: v.cpu().clone() for n, v in tree.items()} for col, tree in variables.items()}
    return rec


def pp_compare(got: dict, ref: dict) -> dict:
    """A pipelined phase-14 run against the single-stage one: the frozen
    logits, the first gradient's largest difference as a share of its
    leaf's largest entry, the step-1 loss in ulps, and the parameters
    after step 1 (largest difference, entries outside phase 12's
    bounds)."""
    import numpy as np
    import torch

    outside = 0
    for n, p in ref["params1"].items():
        g = ref["grads"][n].abs()
        atol = torch.where(g >= MESH_SMALL_GRAD * g.max(), MESH_PARAM_ATOL, MESH_ADAM_ATOL)
        outside += int(((got["params1"][n] - p).abs() > atol + 2.0**-22 * p.abs()).sum())
    return {
        "logits_max_abs_err": float((got["logits"] - ref["logits"]).abs().max()),
        "grad_rel_err": max(float((got["grads"][n] - g).abs().max() / g.abs().max().clamp_min(1e-30))
                            for n, g in ref["grads"].items()),
        "loss_ulps": float(abs(np.float32(got["loss"][0]) - np.float32(ref["loss"][0]))
                           / np.spacing(np.abs(np.float32(ref["loss"][0])))),
        "param1_max_abs_err": max(float((got["params1"][n] - p).abs().max()) for n, p in ref["params1"].items()),
        "params1_outside": outside,
    }


def pp_serve(rec: dict, images, dev) -> dict:
    """The pipe-trained model gathered whole (its EMA weights), frozen by
    ``freeze_vit`` and served by ``build_vit_infer`` with its default
    kernels (K1 + K3) at PP_SERVE_BATCH: the logits against the plain
    engine's, the launches of one forward (every count set to 0 just
    before it and read just after), and K1 and K3 on this model's inputs
    against their plain versions."""
    import torch

    from ivit_tpu_torch.deploy import build_vit_infer, freeze_vit
    from ivit_tpu_torch.kernels import WRAPPERS
    from ivit_tpu_torch.models import create_model

    name, kw = PP_MODEL
    variables = {col: {n: v.to(dev) for n, v in tree.items()} for col, tree in rec["variables"].items()}
    art = freeze_vit(create_model(name, dev, seed=SEED, **kw), variables, dev)
    infer = build_vit_infer(art, dev)
    kernels: dict = {}
    with torch.inference_mode():
        infer(images[:1])  # loads the kernels in this process
        torch.cuda.synchronize()
        for w in WRAPPERS.values():
            w.launches = 0
        logits = infer(images)
        torch.cuda.synchronize()
        launches = {k: w.launches for k, w in WRAPPERS.items() if w.launches}
        plain = build_vit_infer(art, dev, kernels=())(images)
        tp_vit_kernels(kernels, None, infer, images)
    return {"equal": torch.equal(logits, plain), "max_abs_err": float((logits - plain).abs().max()),
            "launches": launches, "kernels": sorted(infer.kernels), "kernel_checks": kernels}


def pp_rank(rank: int, world: int, init_file: str, work: str) -> None:
    """Phase 14, one of two ranks on the card over gloo: rank 0 runs the
    single-process frozen forward and the single-stage step (the other
    rank waits), then both run the pipeline on a ``(1, 2)`` mesh, a stage
    of 6 blocks each; rank 0 compares them and serves the pipe-trained
    model. Writes ``work/rank<r>.pkl``."""
    import pickle

    import torch
    import torch.distributed as dist

    sys.path.insert(0, REPO)
    from ivit_tpu_torch.models import create_model
    from ivit_tpu_torch.parallel import Mesh, init_distributed, make_pp_mesh

    with open(os.path.join(work, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    joined = init_distributed(backend="gloo", device=inp["device"], init_method=f"file://{init_file}", rank=rank,
                              world_size=world)
    dev = joined.device
    name, kw = PP_MODEL
    batches = [(torch.from_numpy(x).to(dev), torch.from_numpy(t).to(dev)) for x, t in inp["batches"]]

    def calibrated():  # one train-mode forward sets every range; the pipeline keeps them frozen
        model = create_model(name, dev, seed=SEED, **kw)
        with torch.no_grad():
            model(torch.from_numpy(inp["calib"]).to(dev), train=True)
        return model

    res = {"device": str(dev), "backend": joined.backend}
    if rank == 0:
        model = calibrated()
        with torch.no_grad():
            seq = model(batches[0][0], train=False).cpu()
        single = pp_train(model, dev, Mesh(1, 1, 0, dev, {}, axis="pipe"), batches)
        del model
        torch.cuda.empty_cache()
    dist.barrier()
    rec = pp_train(calibrated(), dev, make_pp_mesh(1, 2, device=dev), batches)
    res["run"] = {k: rec[k] for k in ("ms", "opt_bytes", "loss")}
    if rank == 0:
        res["forward_max_abs_err"] = float((rec["logits"] - seq).abs().max())
        res["vs_single"] = pp_compare(rec, single)
        res["single"] = {k: single[k] for k in ("ms", "opt_bytes", "loss")}
        del single
        torch.cuda.empty_cache()
        res["serve"] = pp_serve(rec, torch.from_numpy(inp["serve_images"]).to(dev), dev)
    dist.barrier()
    with open(os.path.join(work, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
    dist.destroy_process_group()


def pp_phase(smi: str) -> dict:
    """Phase 14 (``pp_rank`` on two ranks on the card): prints and
    checks each rank's results; returns rank 0's kernel entries of the
    served model."""
    import pickle

    import numpy as np
    import torch
    import torch.multiprocessing as mp

    from ivit_tpu_torch.train import MixupConfig, mixup_cutmix

    t0 = time.perf_counter()
    batches = []
    for i in range(PP_STEPS):
        rng = np.random.default_rng((SEED, 14, i))
        x = torch.from_numpy(rng.standard_normal((PP_BATCH, PP_SIZE, PP_SIZE, 3), dtype=np.float32))
        labels = torch.from_numpy(rng.integers(0, 1000, PP_BATCH))
        x, t = mixup_cutmix(x, labels, MixupConfig(), np.random.default_rng((SEED, 14, i, 1)), device="cpu")
        batches.append((x.numpy(), t.numpy()))
    rng = np.random.default_rng((SEED, 14))
    calib = rng.standard_normal((PP_BATCH, PP_SIZE, PP_SIZE, 3), dtype=np.float32)
    serve_images = rng.standard_normal((PP_SERVE_BATCH, PP_SIZE, PP_SIZE, 3), dtype=np.float32)
    world = 2
    with tempfile.TemporaryDirectory() as work:
        with open(os.path.join(work, "inputs.pkl"), "wb") as f:
            pickle.dump({"device": "cuda", "batches": batches, "calib": calib, "serve_images": serve_images}, f)
        mp.start_processes(pp_rank, args=(world, os.path.join(work, "rendezvous"), work), nprocs=world, join=True,
                           start_method="spawn")
        ranks = []
        for r in range(world):
            with open(os.path.join(work, f"rank{r}.pkl"), "rb") as f:
                ranks.append(pickle.load(f))
    label = f"{PP_LABEL}; mesh (data, pipe) = (1, 2), {PP_MICRO} microbatches of a global batch of {PP_BATCH}"
    print(f"phase 14 GPipe pipeline: {label}; {smi}")
    for r, res in enumerate(ranks):
        check(res["backend"] == "gloo" and res["device"] == "cuda:0", f"rank {r}: {res['device']}")
        run = res["run"]
        print(f"rank {r} pipelined: ms a step {run['ms']}, optimizer-state bytes {run['opt_bytes']} (predicted "
              f"{PP_OPT_BYTES}), loss {run['loss']} ({label})")
        check(run["opt_bytes"] == PP_OPT_BYTES, f"rank {r}: optimizer-state bytes {run['opt_bytes']}, expected "
                                                f"{PP_OPT_BYTES}")
    res = ranks[0]
    single, c = res["single"], res["vs_single"]
    print(f"single-stage step (pipe = 1, one process): ms a step {single['ms']}, optimizer-state bytes "
          f"{single['opt_bytes']}, loss {single['loss']}")
    print(f"pipelined vs the single-process frozen forward: logits max_abs_err {res['forward_max_abs_err']} "
          f"(tolerance 0); vs the single-stage step: logits max_abs_err {c['logits_max_abs_err']}, first gradient "
          f"max err {c['grad_rel_err']} of its leaf's largest (bound {TPQ_GRAD_RTOL}), step-1 loss "
          f"{c['loss_ulps']} ulps (bound {MESH_LOSS_ULPS}), parameters after step 1 max_abs_err "
          f"{c['param1_max_abs_err']}, {c['params1_outside']} entries outside the bounds ({MESH_PARAM_ATOL} where "
          f"the first gradient is not small, {MESH_ADAM_ATOL} where it is)")
    check(res["forward_max_abs_err"] == 0 and c["logits_max_abs_err"] == 0,
          "the pipelined forward differs from the single-process one")
    check(c["grad_rel_err"] <= TPQ_GRAD_RTOL, f"pipelined gradient off by {c['grad_rel_err']}")
    check(c["loss_ulps"] <= MESH_LOSS_ULPS, f"pipelined loss off by {c['loss_ulps']} ulps")
    check(c["params1_outside"] == 0, f"{c['params1_outside']} parameters outside the bounds after step 1")
    sv = res["serve"]
    expect = {"K1": 12, "K3": 25, "K9": 12}  # PP_MODEL has the stable GELU
    print(f"pipe-trained DeiT-S gathered whole, frozen, served by build_vit_infer {sv['kernels']} at batch "
          f"{PP_SERVE_BATCH}: logits vs kernels=() max_abs_err {sv['max_abs_err']} (tolerance 0); launches "
          f"{sv['launches']}")
    check(sv["equal"], "pipe-trained: the kernel engine differs from the plain engine")
    check(sv["launches"] == expect, f"pipe-trained: launches {sv['launches']}, expected {expect}")
    kernels = {}
    for kname, kr in sv["kernel_checks"].items():
        print(f"pipe-trained {kname} on this model's inputs {kr['shape']}: max_abs_err {kr['max_abs_err']} "
              f"(tolerance 0); kernel {kr['ms']} ms (queued {kr['queued_ms']} ms), plain {kr['plain_ms']} ms, bound "
              f"{kr['bound_ms']} ms ({kr['bound_by']})")
        check(kr["max_abs_err"] == 0, f"pipe-trained {kname}: differs from its plain version")
        kernels[kname] = dict(kr, launches=sv["launches"].get(kname))
    print(f"pipeline phase: {time.perf_counter() - t0:.3f} s")
    return kernels


def main() -> int:
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t_main = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(REPO, "ivit_tpu_torch")):
        print("chip_smoke: the ivit_tpu_torch package is not beside this script", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from ivit_tpu_torch import bench as port_bench
    from ivit_tpu_torch import convert_model
    from ivit_tpu_torch.deploy.engine import attention_half, attention_inputs, build_vit_infer, embed, int8_linear
    from ivit_tpu_torch.deploy.graphs import FORWARDS, capture_infer
    from ivit_tpu_torch.ops import INT8, requant, shiftgelu
    from ivit_tpu_torch.deploy.swin_engine import (
        build_swin_infer,
        merge_gather,
        patch_embed,
        swin_trunk,
        window_attention_inputs,
    )
    from ivit_tpu_torch.deploy.swin_synthetic import swin_nonzero_probability_share, synthetic_swin_artifact
    from ivit_tpu_torch.deploy.synthetic import nonzero_probability_share, synthetic_vit_artifact
    from ivit_tpu_torch.kernels import (
        WRAPPERS,
        _build,
        fused_int8_attention,
        fused_int8_attention_long,
        fused_int8_attention_long_reference,
        fused_int8_attention_reference,
        fused_int8_attention_v2,
        fused_int8_attention_v2_reference,
        fused_int8_window_attention,
        fused_int8_window_attention_reference,
        fused_layernorm_requant,
        fused_layernorm_requant_reference,
        fused_linear_shiftgelu,
        fused_linear_shiftgelu_reference,
        fused_requant_shiftgelu,
        fused_requant_shiftgelu_reference,
        fused_requant_shiftmax,
        fused_requant_shiftmax_reference,
        fused_requant_stable_gelu,
        fused_requant_stable_gelu_reference,
        stable_gelu_table,
    )
    from ivit_tpu_torch.kernels._gelu_common import gelu_table, gelu_table_on
    from ivit_tpu_torch.kernels.attention_fused import attention_probabilities
    from ivit_tpu_torch.kernels.attention_fused_v2 import scale_gate
    from ivit_tpu_torch.kernels.window_attention_fused import window_attention_probabilities
    from ivit_tpu_torch.models.swin import sw_attn_mask
    from ivit_tpu_torch.utils import load_artifact

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    dev = torch.device("cuda", 0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    # 2. build
    t0 = time.perf_counter()
    libs = _build.build(force=True)
    _build.load()
    print(f"build: nvcc {' '.join(_build.NVCC_FLAGS)}, {len(libs)} sources in parallel "
          f"-> {_build.BUILD_DIR} in {time.perf_counter() - t0:.3f} s")
    # registers, spill stack and static shared memory of the tensor-core
    # kernels, as built (they set how many blocks an SM holds), and the
    # IMMA (int8 tensor-core) instructions in the SASS of K4's and K7's
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    kernel_names = (
        ("K1", "attention_fused.cu", r"attention_mma_kernelILb(\d)ELb(\d)ELi(\d)E", "<kV2={}, out_bits 16={}, depth={}>"),
        ("K2", "attention_fused_v2.cu", r"attention_mma_kernelILb(\d)ELb(\d)ELi(\d)E", "<kV2={}, out_bits 16={}, depth={}>"),
        ("K3", "intnorm_fused.cu", r"fused_layernorm_requant_kernelILi(\d+)ELb(\d)E", "<G={}, vec={}>"),
        ("K4", "linear_gelu_fused.cu", r"(fused_linear_shiftgelu_kernel)ILi(\d)E|(gelu_table_kernel)", "{}"),
        ("K5", "shiftgelu_fused.cu", r"(fused_requant_shiftgelu_kernel)", "{}"),
        ("K6", "shiftmax_fused.cu", r"fused_requant_shiftmax_kernelILi(\d+)E", "<copy bytes={}>"),
        ("K7", "window_attention_fused.cu", r"window_attention_kernelILi(\d)ELi(\d+)ELb(\d)E", "<depth={}, key tiles={}, masked={}>"),
        ("K9", "stable_gelu_fused.cu", r"stable_gelu_table_kernel\D*(\d)", "<channels a thread={}>"),
    )
    for name, source, pattern, form in kernel_names:
        lib = _build.lib_path(source)
        usage = subprocess.run([cuobjdump, "--dump-resource-usage", lib], capture_output=True, text=True,
                               check=True).stdout.splitlines()
        for fn, res in zip(usage, usage[1:]):
            args = re.search(pattern, fn)
            if args and "REG:" in res:
                label = form.format(*(a for a in args.groups() if a is not None))
                print(f"{name} resources: {label}: {' '.join(res.split()[:4])}")
        if name in ("K4", "K7"):
            imma, fn = {}, None
            for line in subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True,
                                       check=True).stdout.splitlines():
                if "Function :" in line:
                    fn = line.split("Function :")[1].strip()
                elif fn is not None and "IMMA" in line:
                    imma[fn] = imma.get(fn, 0) + 1
            for fn, count in sorted(imma.items()):
                args = re.search(pattern, fn)
                label = form.format(*(a for a in args.groups() if a is not None)) if args else fn
                print(f"{name} SASS: {label}: {count} IMMA instructions")
            check(len(imma) > 0, f"{name}: no IMMA instruction in {source}")

    # the paths' inputs
    t0 = time.perf_counter()
    art8 = synthetic_vit_artifact("deit_small", seed=SEED, softmax_bits=8, gelu_stable=True)
    art16 = synthetic_vit_artifact("deit_small", seed=SEED, softmax_bits=16, gelu_stable=False)
    cfg = art8["config"]
    print(f"artifacts: synthetic deit_small seed={SEED} {cfg} and softmax_bits=16 gelu_stable=False "
          f"in {time.perf_counter() - t0:.3f} s")
    rng = np.random.default_rng(SEED + 1)
    size = cfg["img_size"]
    images = torch.from_numpy(rng.standard_normal((BATCH, size, size, 3), dtype=np.float32))
    images_dev = images.to(dev)
    D, H, depth = cfg["embed_dim"], cfg["num_heads"], cfg["depth"]
    hd, N = D // H, (cfg["img_size"] // cfg["patch_size"]) ** 2 + 1
    hidden = int(D * cfg["mlp_ratio"])

    infer = build_vit_infer(art8, dev)  # the main path: the default kernels, K1 + K3
    routes16 = {
        "A": build_vit_infer(art16, dev, kernels=ROUTE_A),
        "B": build_vit_infer(art16, dev, kernels=ROUTE_B),
        "K1": build_vit_infer(art16, dev),
    }
    t0 = time.perf_counter()
    art_swin = synthetic_swin_artifact("swin_tiny", seed=SEED)
    scfg = art_swin["config"]
    print(f"artifact: synthetic swin_tiny seed={SEED} {scfg} in {time.perf_counter() - t0:.3f} s")
    swin = build_swin_infer(art_swin, dev)  # the Swin path: its default kernels, K7 + K3
    for name, r in [("main", infer), *routes16.items(), ("swin", swin)]:
        print(f"route {name}: kernels {sorted(r.kernels)}")
    scales = [b["attn"]["scale"] for b in routes16["A"].tensors["blocks"]]
    print(f"K2 gate N*ceil(1/scale)*2^15 < 2^31 at N={N}: softmax input scales {scales}, "
          f"all pass {all(scale_gate(N, s) for s in scales)}")

    # 3. kernels against their plain versions at the paths' shapes
    t8, t16 = infer.tensors, routes16["A"].tensors
    blk8, blk16 = t8["blocks"][0], t16["blocks"][0]
    with torch.inference_mode():
        x128, x1 = embed(images_dev, t8), embed(images_dev[:1], t8)
        x16 = {"b128": embed(images_dev, t16), "b1": embed(images_dev[:1], t16)}
    gen = torch.Generator().manual_seed(SEED)
    errs = {k: 0 for k in WRAPPERS}

    def compare(name: str, label: str, out, ref, quiet: bool = False) -> None:
        torch.cuda.synchronize()
        outs = out if isinstance(out, tuple) else (out,)
        refs = ref if isinstance(ref, tuple) else (ref,)
        err = max(max_abs_err(o, r) for o, r in zip(outs, refs))
        errs[name] = max(errs[name], err)
        if not quiet:
            distinct = int(refs[0].unique().numel())
            print(f"{name} {label}: max_abs_err {err} (tolerance 0), distinct outputs {distinct}")
        check(err == 0, f"{name} {label} differs from its plain version")

    k3_cases = {f"({BATCH * N}, {D})": x128.reshape(-1, D), f"({N}, {D})": x1.reshape(-1, D),
                f"({BATCH}, {D}) final norm": x128[:, 0].contiguous()}
    for shape, x in k3_cases.items():
        args = (x, blk8["norm1"]["bias_int"], blk8["norm1"]["ratio"])
        compare("K3", shape, fused_layernorm_requant(*args), fused_layernorm_requant_reference(*args))

    # K1 and K2: the block-0 q, k, v of each path, random spread inputs and
    # edge inputs
    s8 = {k: np.float32(art8["blocks"][0][k]) for k in ("s_attn_qact1", "s_attn_out")}
    spread_r1 = float(np.float32(127.0 / (3 * np.sqrt(hd) * 74.0**2)))
    spread_scale = float(np.float32(0.07))

    def r_out_at(bits: int) -> float:
        """The main path's block-0 r_out at this probability width (f32, as the engine forms it)."""
        return float(np.float32(np.float32(1.0 / 2 ** (bits - 1)) * s8["s_attn_qact1"]) / s8["s_attn_out"])

    def edge_inputs(G: int, n_tok: int, d: int) -> list:
        """Random int8 q, k, v whose first cells hold the edges: equal
        scores (q = 0), and every score clipped at -128 or at +127 against
        V = -128 (the largest |context|)."""
        q, k, v = (torch.randint(-128, 128, (G, n_tok, d), generator=gen, dtype=torch.int8) for _ in range(3))
        c = max(G // 4, 1)
        q[:c] = 0
        q[c:2 * c], k[c:2 * c], v[c:2 * c] = 127, -128, -128
        q[2 * c:3 * c], k[2 * c:3 * c], v[2 * c:3 * c] = 127, 127, -128
        return [t.to(dev) for t in (q, k, v)]

    def compare_attention(q, k, v, r1, scale, r_out, bits, data, quiet=False) -> None:
        n_tok = q.shape[1]
        label = f"({', '.join(map(str, q.shape))}) out_bits={bits} {data}"
        if not quiet:
            probs = attention_probabilities(q, k, r1, scale, bits)
            label += f", nonzero probabilities {float((probs > 0).float().mean())}"
        compare("K1", label, fused_int8_attention(q, k, v, r1, scale, r_out, bits),
                fused_int8_attention_reference(q, k, v, r1, scale, r_out, bits), quiet)
        if scale_gate(n_tok, scale):
            compare("K2", label, fused_int8_attention_v2(q, k, v, r1, scale, r_out, n_tok, bits),
                    fused_int8_attention_v2_reference(q, k, v, r1, scale, r_out, n_tok, bits), quiet)

    attn_inputs = {}
    for size, xa, xb in (("b128", x128, x16["b128"]), ("b1", x1, x16["b1"])):
        with torch.inference_mode():
            attn_inputs[size] = {"sm8": attention_inputs(xa, blk8, H), "sm16": attention_inputs(xb, blk16, H)}
    for size, ins in attn_inputs.items():
        q8, k8, v8 = ins["sm8"]
        G = q8.shape[0]
        rand = [torch.randint(-128, 128, (G, N, hd), generator=gen, dtype=torch.int8).to(dev) for _ in range(3)]
        edges = edge_inputs(G, N, hd)
        for bits in (8, 16):
            r_out8 = r_out_at(bits)
            a16 = blk16["attn"]
            cases = [
                ("main-path block0", ins["sm8"], blk8["attn"]["r1"], blk8["attn"]["scale"], r_out8),
                ("random", rand, spread_r1, spread_scale, r_out8),
            ]
            if bits == 16:
                cases.insert(1, ("sm16 block0", ins["sm16"], a16["r1"], a16["scale"], a16["r_out"]))
            cases += [("edges", edges, spread_r1, spread_scale, r_out8),
                      ("edges, power-of-two 1/scale", edges, spread_r1, POW2_SCALE, r_out8)]
            for data, (qq, kk, vv), r1, scale, r_out in cases:
                compare_attention(qq, kk, vv, r1, scale, r_out, bits, data)
    # one-token rows at a power-of-two 1/scale (probability 2^(out_bits-1)),
    # at the paths' cell counts, and every N in ATTN_N against every hd in
    # ATTN_HD, each on the edge inputs
    for G in (BATCH * H, H):
        for bits in (8, 16):
            qq, kk, vv = edge_inputs(G, 1, hd)
            probs = attention_probabilities(qq, kk, spread_r1, POW2_SCALE, bits)
            check(float(probs.max()) == 2.0 ** (bits - 1), f"one-token rows: probability {float(probs.max())}")
            compare_attention(qq, kk, vv, spread_r1, POW2_SCALE, r_out_at(bits), bits, "one-token rows")
    for n_tok in ATTN_N:
        for hd_ in ATTN_HD:
            qq, kk, vv = edge_inputs(5, n_tok, hd_)
            r1 = float(np.float32(127.0 / (3 * np.sqrt(hd_) * 74.0**2)))
            for bits in (8, 16):
                for scale in (spread_scale, POW2_SCALE):
                    compare_attention(qq, kk, vv, r1, scale, r_out_at(bits), bits, f"edges scale {scale}", quiet=True)
    print(f"K1, K2: max_abs_err 0 (tolerance 0) at N in {ATTN_N} x hd in {ATTN_HD} (G = 5) on the edge inputs, "
          f"out_bits 8 and 16, scales {spread_scale} and {POW2_SCALE}")

    # K6: the block-0 scores of the sm16 path and random spread scores
    def scores(q, k):
        return torch.matmul(q.double(), k.double().transpose(-1, -2)).to(torch.int32).reshape(-1, N)

    k6_inputs = {}
    for size, ins in attn_inputs.items():
        q16, k16, _ = ins["sm16"]
        G = q16.shape[0]
        rq, rk = (torch.randint(-128, 128, (G, N, hd), generator=gen, dtype=torch.int8).to(dev) for _ in range(2))
        a16 = blk16["attn"]
        k6_inputs[size] = (scores(q16, k16), a16["r1"], a16["scale"])
        for data, (x, r1, scale) in (("sm16 block0", k6_inputs[size]), ("random", (scores(rq, rk), spread_r1, spread_scale))):
            compare("K6", f"({x.shape[0]}, {N}) {data}", fused_requant_shiftmax(x, r1, scale, N),
                    fused_requant_shiftmax_reference(x, r1, scale, N))
    # the block-0 scores from a row-slice view: the base 4 bytes past a
    # 16-byte boundary (the kernel's 4-byte copies), M not a multiple of
    # the 16-row tile
    x, r1, scale = k6_inputs["b128"]
    check(x[1:].data_ptr() % 16 == 4, f"row-slice view at {x[1:].data_ptr() % 16} bytes past 16")
    compare("K6", f"({x.shape[0] - 1}, {N}) sm16 block0 row-slice view", fused_requant_shiftmax(x[1:], r1, scale, N),
            fused_requant_shiftmax_reference(x[1:], r1, scale, N))

    # K6 on edge rows (uniform: x = 0; all valid at -128: x = -2^30; one-hot:
    # 2^30 in column 0), spread rows elsewhere, at N in K6_N with n_valid
    # below N and at N, out_bits 8 and 16, a spread scale and a power-of-two
    # 1/scale (one-token rows: sm = 2^15 and hi saturates to 127), M = 7 and
    # 1182, from a 16-byte aligned base and from one 4 bytes past
    k6_r1 = float(np.float32(100.0 / 2**20))  # the spread rows span the int8 clip
    saturated = 0
    for n_tok in K6_N:
        for M in (7, H * N):
            ex = torch.randint(-(2**20), 2**20, (M, n_tok), generator=gen, dtype=torch.int32)
            ex[0], ex[1], ex[2, 0] = 0, -(2**30), 2**30
            buf = torch.empty(M * n_tok + 1, dtype=torch.int32, device=dev)
            buf[1:] = ex.reshape(-1).to(dev)
            bases = {"aligned": ex.to(dev), "offset": buf[1:].view(M, n_tok)}
            check(bases["offset"].data_ptr() % 16 == 4, "K6 edges: offset base")
            for n_valid in sorted({n_tok, (n_tok + 1) // 2, 1}):
                for bits in (8, 16):
                    for scale in (spread_scale, POW2_SCALE):
                        for base, xe in bases.items():
                            ref = fused_requant_shiftmax_reference(xe, k6_r1, scale, n_valid, bits)
                            if n_valid == 1 and scale == POW2_SCALE and bits == 16:  # sm = 2^15 in column 0
                                check(bool((ref[0][:, 0] == 127).all() and (ref[1][:, 0] == -128).all()),
                                      "K6 edges: a one-token row's hi did not saturate")
                                saturated += M
                            compare("K6", f"edges ({M}, {n_tok}) n_valid={n_valid} out_bits={bits} scale={scale} {base}",
                                    fused_requant_shiftmax(xe, k6_r1, scale, n_valid, bits), ref, quiet=True)
    print(f"K6: max_abs_err 0 (tolerance 0) on edge rows at N in {K6_N}, n_valid below and at N, out_bits 8 and 16, "
          f"scales {spread_scale} and {POW2_SCALE}, M = 7 and 1182, aligned and offset bases; {saturated} one-token rows "
          "with hi saturated to 127")

    # K4 and K5: the block-0 MLP inputs of the sm16 path, and random inputs
    # whose per-channel ratios spread the GELU inputs over int8
    fc1, gelu = blk16["fc1"], blk16["gelu"]
    gelu_args = (gelu["s_in"], gelu["r2"])
    k4_inputs, k5_inputs = {}, {}
    for size, xs in x16.items():
        with torch.inference_mode():
            y = fused_layernorm_requant_reference(attention_half(xs, blk16, t16["config"], ()),
                                                  blk16["norm2"]["bias_int"], blk16["norm2"]["ratio"])
            acc = int8_linear(y, fc1)
        M = y.shape[0]
        k4_inputs[size] = (y, fc1["w_t"].T, fc1["b"], fc1["ratio"], *gelu_args)
        k5_inputs[size] = (acc, fc1["ratio"], *gelu_args)
        ry = torch.randint(-128, 128, (M, D), generator=gen, dtype=torch.int8).to(dev)
        spread = torch.from_numpy((np.random.default_rng(M).uniform(0.5, 2.0, hidden)).astype(np.float32)).to(dev)
        r1_gemm = spread * float(40.0 / (74.0**2 * np.sqrt(D)))
        racc = torch.randint(-(2**20), 2**20, (M, hidden), generator=gen, dtype=torch.int32).to(dev)
        racc[0] = -racc[0].abs() - 1  # an all-negative row: e_max saturates
        for data, args in (("sm16 block0", k4_inputs[size]), ("random", (ry, fc1["w_t"].T, fc1["b"], r1_gemm, *gelu_args))):
            compare("K4", f"({M}, {D}) x ({D}, {hidden}) {data}", fused_linear_shiftgelu(*args),
                    fused_linear_shiftgelu_reference(*args))
        for data, args in (("sm16 block0", k5_inputs[size]), ("random", (racc, spread * 1e-4, *gelu_args))):
            compare("K5", f"({M}, {hidden}) {data}", fused_requant_shiftgelu(*args),
                    fused_requant_shiftgelu_reference(*args))

    # K4 on edge rows (row 0 all negative: x = 0 against a negative bias,
    # e_max saturates; row 1 tied at its max: x = 127 against 16 weight
    # columns of 127, which clip) at the path's shapes and at an M and a C
    # that are not multiples of the 64-row blocks and 256-column chunks,
    # and the GELU tables the card filled against their torch twin
    def k4_edges(M: int, C: int) -> tuple:
        ex = torch.randint(-128, 128, (M, D), generator=gen, dtype=torch.int8)
        ew = torch.randint(-128, 128, (C, D), generator=gen, dtype=torch.int8)
        eb = torch.randint(-(2**15), -(2**14), (C,), generator=gen, dtype=torch.int32)
        ex[0], ex[1], ew[:16] = 0, 127, 127
        er1 = torch.from_numpy((np.random.default_rng(C).uniform(0.5, 2.0, C) * 40.0 / (74.0**2 * np.sqrt(D))).astype(np.float32))
        return ex.to(dev), ew.to(dev).T, eb.to(dev), er1.to(dev), *gelu_args

    for M, C in ((BATCH * N, hidden), (N, hidden), (BATCH * N - 5, hidden - 40)):
        args = k4_edges(M, C)
        ref = fused_linear_shiftgelu_reference(*args)
        check(bool((ref[0] <= 0).all()), "K4 edges: row 0 is not all negative")
        compare("K4", f"({M}, {D}) x ({D}, {C}) edge rows", fused_linear_shiftgelu(*args), ref)
    gelu_pairs = sorted({(b["gelu"]["s_in"], b["gelu"]["r2"]) for b in t16["blocks"]})
    for s_in, r2 in gelu_pairs:
        compare("K4", f"GELU table s_in={s_in} r2={r2}", gelu_table_on(dev, s_in, r2), gelu_table(s_in, r2).to(dev),
                quiet=True)
    print(f"K4 GELU tables of the {len(gelu_pairs)} (s_in, r2) of route A: equal to their torch twin "
          "(tolerance 0)")

    # K5 on edge rows: all negative (e_max saturates), +127 / -128
    # alternating, all -128, tied at a max of +127 (every fifth channel
    # clips), spread rows elsewhere; at route B's shape, small and ragged
    # ones and a width past the 1,536 channels a lane keeps
    for M, C in ((BATCH * N, hidden), (33, 256), (5, 100), (100, 2048)):
        ex = torch.randint(-(2**20), 2**20, (M, C), generator=gen, dtype=torch.int32)
        ex[0] = -ex[0].abs() - 2**15 - 1
        ex[1, ::2], ex[1, 1::2] = 2**30, -(2**30)
        ex[2] = -(2**30)
        ex[3, ::5] = 2**30
        er1 = torch.from_numpy((np.random.default_rng(C).uniform(0.5, 2.0, C) * 1e-4).astype(np.float32))
        args = (ex.to(dev), er1.to(dev), *gelu_args)
        ref = fused_requant_shiftgelu_reference(*args)
        check(bool((ref[0] <= 0).all()), "K5 edges: row 0 is not all negative")
        compare("K5", f"({M}, {C}) edge rows", fused_requant_shiftgelu(*args), ref)

    # K9, the main path's fc1 epilogue: block 0's fc1 accumulators of the
    # sm8 stable path at batch 128 and 1 (also against the plain chain the
    # engine runs with kernels=()), random accumulators whose ratios spread
    # q over int8, and edge inputs (|x + b| above 2^24 where the float32
    # conversion rounds, a bias add that wraps, rows clipping at +127 and
    # -128) at the path's shapes, a ragged M, a width past 128 words and an
    # odd C, from 16-byte aligned bases and from bases 4 bytes past one
    # (the one-channel path); the tables the engine filled on the card
    # against the CPU's
    fc1_8, gelu8 = blk8["fc1"], blk8["gelu"]

    def k9_chain(acc, b, r1, table):
        g, _ = shiftgelu(requant(acc + b, r1, *INT8), gelu8["scale"], out_bits=8, stable=True)
        return requant(g, gelu8["ratio"], *INT8).to(torch.int8)

    k9_inputs = {}
    for size, xs in (("b128", x128), ("b1", x1)):
        with torch.inference_mode():
            y = fused_layernorm_requant_reference(attention_half(xs, blk8, t8["config"], ()),
                                                  blk8["norm2"]["bias_int"], blk8["norm2"]["ratio"])
            acc9 = int8_linear(y, fc1_8, bias=False)
        M = acc9.shape[0]
        k9_inputs[size] = (acc9, fc1_8["b"], fc1_8["ratio"], gelu8["table"])
        racc = torch.randint(-(2**20), 2**20, (M, hidden), generator=gen, dtype=torch.int32).to(dev)
        rr1 = torch.from_numpy((np.random.default_rng(M).uniform(0.5, 2.0, hidden) * 1e-4).astype(np.float32)).to(dev)
        for data, args in (("sm8 block0", k9_inputs[size]), ("random", (racc, fc1_8["b"], rr1, gelu8["table"]))):
            out9 = fused_requant_stable_gelu(*args)
            compare("K9", f"({M}, {hidden}) {data}", out9, fused_requant_stable_gelu_reference(*args))
            if data == "sm8 block0":
                compare("K9", f"({M}, {hidden}) {data} against the plain chain", out9, k9_chain(*args))

    def off16(t):
        """``t`` on the card from a base 4 bytes past a 16-byte boundary."""
        out = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)[1:].view(t.shape)
        return out.copy_(t)

    for M, C in ((BATCH * N, hidden), (N, hidden), (BATCH * N - 5, hidden), (37, hidden + 4), (5, 99)):
        ex = torch.randint(-(2**20), 2**20, (M, C), generator=gen, dtype=torch.int32)
        eb = torch.randint(-(2**16), 2**16, (C,), generator=gen, dtype=torch.int32)
        er1 = torch.from_numpy((np.random.default_rng(C).uniform(0.5, 2.0, C) * 1e-4).astype(np.float32))
        ex[:, ::7] = torch.randint(-(2**27), 2**27, (M, len(range(0, C, 7))), generator=gen, dtype=torch.int32) | 1
        eb[::7], er1[::7] = 0, float(np.float32(9e-7))
        ex[1], ex[2] = 2**30, -(2**30)
        eb[3] = 2**31 - 1
        ex[:, 3] = ex[:, 3].abs() + 1  # x + b wraps
        q9 = requant(ex + eb, er1, *INT8)
        check(bool((q9[1, 4:] == 127).all() and (q9[2, 4:] == -128).all() and (q9[1:, 3] == -128).all()),
              f"K9 edges ({M}, {C}): rows 1 and 2 do not clip, or channel 3's bias add does not wrap")
        for base in ("aligned", "offset"):
            args = (*(off16(a) if base == "offset" else a.to(dev) for a in (ex, eb, er1)), gelu8["table"])
            ref = fused_requant_stable_gelu_reference(*args)
            compare("K9", f"({M}, {C}) edges {base}", fused_requant_stable_gelu(*args), ref, quiet=True)
    for i, blk9 in enumerate(t8["blocks"]):
        compare("K9", f"table of block {i}", blk9["gelu"]["table"],
                stable_gelu_table(blk9["gelu"]["scale"].cpu(), blk9["gelu"]["ratio"].cpu()).to(dev), quiet=True)
    print(f"K9: max_abs_err 0 (tolerance 0) on edge inputs at ({BATCH * N}, {hidden}), ({N}, {hidden}), "
          f"({BATCH * N - 5}, {hidden}), (37, {hidden + 4}) and (5, 99), aligned and offset bases; the "
          f"{depth} tables the engine filled on the card equal to the CPU's")

    # K7 and K3 on the Swin path's own inputs at batch 128 and batch 1:
    # each stage's block 0 (unshifted) and block 1 (shifted, masked in
    # stages 1-3) window q, k, v, and the norm inputs of each stage's
    # first block and of each patch merging
    ts = swin.tensors
    where = {}
    for i, st in enumerate(ts["stages"]):
        where.update({id(b): (i, j) for j, b in enumerate(st["blocks"])})
        if "downsample" in st:
            where[id(st["downsample"])] = (i, "merge")
    window_inputs, swin_norm_inputs = {}, {}
    for size, imgs in (("b128", images_dev), ("b1", images_dev[:1])):
        def visit(layer, x, size=size):
            i, j = where[id(layer)]
            if j == "merge":
                swin_norm_inputs[(size, f"merge {i + 1}")] = (merge_gather(x, layer["res"]), layer["norm"])
                return
            if j == 0:
                swin_norm_inputs[(size, f"stage {i + 1}")] = (x.reshape(-1, x.shape[-1]), layer["norm1"])
            if j < 2:
                window_inputs[(size, i, j)] = (layer, window_attention_inputs(x, layer, kernels=()))

        with torch.inference_mode():
            swin_trunk(patch_embed(imgs, ts), ts, (), on_layer=visit)
    for (size, label), (x, norm) in swin_norm_inputs.items():
        args = (x, norm["bias_int"], norm["ratio"])
        compare("K3", f"Swin-T {label} {tuple(x.shape)}", fused_layernorm_requant(*args),
                fused_layernorm_requant_reference(*args))

    # K3 on edge rows at every path width and its batch-128 row count:
    # zero variance (at 3 and at -32768), alternating 32767 and -32768,
    # values in +-60, spread rows elsewhere; with 16-byte loads and, from
    # a base 2 bytes past a 16-byte boundary, the scalar instantiation;
    # then the ragged widths and the split statistics (C > 1000)
    def k3_edges(M: int, C: int, offset: int = 0) -> tuple:
        x = torch.randint(-(2**15), 2**15, (M, C), generator=gen, dtype=torch.int16)
        x[0], x[1] = 3, -(2**15)
        x[2, ::2], x[2, 1::2] = 32767, -32768
        x[3] = torch.randint(-60, 61, (C,), generator=gen, dtype=torch.int16)
        buf = torch.empty(M * C + offset, dtype=torch.int16, device=dev)
        buf[offset:] = x.reshape(-1).to(dev)
        rng_c = np.random.default_rng(C)
        bias = torch.from_numpy(np.floor(rng_c.standard_normal(C) * 2**24).astype(np.float32)).to(dev)
        ratio = torch.from_numpy((rng_c.uniform(0.5, 2.0, C) * np.sqrt(C) * 2.0**-25).astype(np.float32)).to(dev)
        return buf[offset:].view(M, C), bias, ratio

    k3_widths = {96: 401408, 192: 100352, 384: BATCH * N, 768: 25088, 1536: 6272}
    for C, M in k3_widths.items():
        for offset in (0, 1):
            args = k3_edges(M if offset == 0 else M // 8 + 3, C, offset)
            compare("K3", f"edges ({args[0].shape[0]}, {C}) {'scalar' if offset else '16-byte'} loads",
                    fused_layernorm_requant(*args), fused_layernorm_requant_reference(*args), quiet=True)
    for M, C in ((1003, 100), (1003, 33), (517, 1000), (517, 1001), (67, 8192)):
        args = k3_edges(M, C)
        compare("K3", f"edges ({M}, {C})", fused_layernorm_requant(*args), fused_layernorm_requant_reference(*args),
                quiet=True)
    print(f"K3: max_abs_err 0 (tolerance 0) on edge rows at C in {tuple(k3_widths)} with 16-byte and scalar "
          "loads, and at (1003, 100), (1003, 33), (517, 1000), (517, 1001), (67, 8192)")
    spread_r1_w = float(np.float32(127.0 / (3 * np.sqrt(32) * 74.0**2)))

    def window_shape(q, a) -> str:
        return f"({', '.join(map(str, q.shape))}) {'masked' if a['mask'] is not None else 'unmasked'}"

    for (size, i, j), (blk, (q, k, v)) in window_inputs.items():
        a, heads = blk["attn"], blk["heads"]
        rand = [torch.randint(-128, 128, q.shape, generator=gen, dtype=torch.int8).to(dev) for _ in range(3)]
        for data, (qq, kk, vv), r1 in (("Swin-T block inputs", (q, k, v), a["r1"]), ("random", rand, spread_r1_w)):
            args = (qq, kk, vv, a["bias"], a["mask"], r1, a["rb"], a["scale"], a["r_out"], heads)
            probs = window_attention_probabilities(qq, kk, a["bias"], a["mask"], r1, a["rb"], a["scale"], heads)
            label = (f"stage {i + 1} block {j} {window_shape(q, a)} {data}, "
                     f"nonzero probabilities {float((probs > 0).float().mean())}")
            compare("K7", label, fused_int8_window_attention(*args), fused_int8_window_attention_reference(*args))

    # K7 at every Swin-T stage shape, batch 128 and 1, on edge inputs:
    # spread q, k, v with cells of tied scores (q = 0) and of clipped ones
    # (q = 127, k = -128), an integer bias, unmasked; masked with the
    # stage's shifted-window plane (stage 4's from the 7 x 7 geometry) at
    # a Swin-like scale, where every masked argument lies at or below the
    # shift-exp clamp; and at s_bias = 0.45, where the rows of window 0
    # that have a masked column get bias 127 there and -100 or -300
    # elsewhere: masked arguments above the clamp take the chain, and
    # masked scores become row maxima
    for (size, i, j), (blk, (q, _, _)) in window_inputs.items():
        if j != 0:
            continue
        (G, Nw, hdw), heads, res, ws = q.shape, blk["heads"], blk["res"], blk["ws"]
        plane = sw_attn_mask(res, res, ws, max(ws // 2, 1))
        qq, kk, vv = (torch.randint(-128, 128, (G, Nw, hdw), generator=gen, dtype=torch.int8) for _ in range(3))
        c = max(G // 8, 1)
        qq[:c] = 0
        qq[c:2 * c], kk[c:2 * c] = 127, -128
        qq, kk, vv = qq.to(dev), kk.to(dev), vv.to(dev)
        for label, scale, low in (("unmasked", 0.07, None), ("masked", 0.07, None),
                                  ("masked above the clamp", 0.45, -100.0), ("masked row maxima", 0.45, -300.0)):
            scale = float(np.float32(scale))
            bias = torch.randint(-30, 31, (heads, Nw, Nw), generator=gen).float()
            if low is not None:
                hit = torch.from_numpy(plane[0] != 0)
                bias[:] = torch.where(hit, 127.0, torch.where(hit.any(-1, keepdim=True), low, bias))
            mask = None if label == "unmasked" else torch.from_numpy(plane / np.float32(scale)).to(dev)
            args = (qq, kk, vv, bias.to(dev), mask, spread_r1_w, float(np.float32(0.9)), scale,
                    float(np.float32(0.05 / 128 / 0.021)), heads)
            compare("K7", f"stage {i + 1} {size} ({G}, {Nw}, {hdw}) edges, {label}, s_bias {scale}",
                    fused_int8_window_attention(*args), fused_int8_window_attention_reference(*args), quiet=True)
    print("K7: max_abs_err 0 (tolerance 0) at every Swin-T stage shape, batch 128 and 1, on edge inputs: "
          "unmasked, masked at s_bias 0.07, masked arguments above the clamp and masked row maxima at 0.45")

    # GEMM widths that are not multiples of 8: a 100-class DeiT head (N =
    # 100) and Swin at patch 2 (a patch-embed K of 12), through the
    # zero-padded weights of carry_linear, on the card against the plain
    # engine on the CPU
    odd_widths = {
        "DeiT num_classes=100": (build_vit_infer, 32, synthetic_vit_artifact(
            "deit_tiny", seed=SEED, img_size=32, patch_size=8, embed_dim=128, depth=2, num_heads=2,
            num_classes=100)),
        "Swin patch_size=2": (build_swin_infer, 16, synthetic_swin_artifact(
            "swin_tiny", seed=SEED, img_size=16, patch_size=2, embed_dim=16, depths=(2, 2), num_heads=(2, 4),
            window_size=4, num_classes=8)),
    }
    for label, (build, side, art) in odd_widths.items():
        w_odd = art["head" if build is build_vit_infer else "patch_embed"]["w"]
        try:
            torch._int_mm(torch.zeros((1024, w_odd.shape[0]), dtype=torch.int8, device=dev), torch.from_numpy(w_odd).to(dev))
            refusal = "takes it"
        except RuntimeError as e:
            refusal = f"raises {str(e).splitlines()[0]!r}"
        print(f"widths {label}: torch._int_mm on the unpadded {tuple(w_odd.shape)} weight {refusal}")
        imgs = torch.from_numpy(rng.standard_normal((3, side, side, 3), dtype=np.float32))
        cpu_logits = build(art, "cpu", kernels=())(imgs)
        for kernels in ("default", ()):
            fn = build(art, dev) if kernels == "default" else build(art, dev, kernels=kernels)
            logits_odd = fn(imgs.to(dev)).cpu()
            e_odd = float((logits_odd - cpu_logits).abs().max())
            print(f"widths {label}, kernels {sorted(fn.kernels)}: logits {tuple(logits_odd.shape)} vs the plain "
                  f"engine on the CPU: max_abs_err {e_odd} (tolerance 0)")
            check(torch.equal(logits_odd, cpu_logits), f"widths {label}: differs from the CPU plain engine")

    # 4. each path end to end, its launch counts read around its own run
    def drive(name: str, fn, expect: dict) -> tuple:
        for w in WRAPPERS.values():
            w.launches = 0
        out128 = fn(images_dev)
        out1 = fn(images_dev[:1])
        torch.cuda.synchronize()
        counts = {k: w.launches for k, w in WRAPPERS.items()}
        print(f"route {name}: launches over 2 forwards (batch {BATCH}, batch 1): {counts}")
        for k, per_forward in expect.items():
            check(counts[k] == 2 * per_forward, f"route {name}: {k} launched {counts[k]} times, expected {2 * per_forward}")
        check(sum(counts.values()) == 2 * sum(expect.values()), f"route {name}: unexpected launches {counts}")
        check(tuple(out128.shape) == (BATCH, cfg["num_classes"]), f"logits shape {tuple(out128.shape)}")
        check(bool(torch.isfinite(out128).all()), f"route {name}: non-finite logits")
        e_b1 = float((out1 - out128[:1]).abs().max())
        print(f"route {name}: logits batch 1 vs row 0 of batch {BATCH}: max_abs_err {e_b1} (tolerance 0)")
        check(torch.equal(out1, out128[:1]), f"route {name}: batch 1 differs from row 0 of the batch")
        return out128, counts

    def against_plain(name: str, logits, plain, cpu2) -> None:
        e_plain = float((logits - plain).abs().max())
        e_cpu = float((logits[:2].cpu() - cpu2).abs().max())
        print(f"route {name}: logits vs plain ops on the card: max_abs_err {e_plain}; "
              f"rows 0-1 vs plain engine on the CPU: max_abs_err {e_cpu} (tolerance 0)")
        check(torch.equal(logits, plain), f"route {name}: differs from the plain ops on the card")
        check(torch.equal(logits[:2].cpu(), cpu2), f"route {name}: differs from the CPU plain engine")

    layernorms = 2 * depth + 1
    main_expect = {"K1": depth, "K3": layernorms, "K9": depth}
    logits, main_counts = drive("main", infer, main_expect)
    plain8 = build_vit_infer(art8, dev, kernels=())
    against_plain("main", logits, plain8(images_dev), build_vit_infer(art8, "cpu", kernels=())(images[:2]))
    shares = nonzero_probability_share(art8, images[:8], dev)
    print(f"non-degeneracy (main path): nonzero attention probabilities per block {shares}; "
          f"distinct argmax over {BATCH} images {int(logits.argmax(-1).unique().numel())}; "
          f"logit std {float(logits.std())}")

    plain16 = build_vit_infer(art16, dev, kernels=())
    plain16_logits = plain16(images_dev)
    cpu16 = build_vit_infer(art16, "cpu", kernels=())(images[:2])
    expects = {"A": {"K2": depth, "K4": depth, "K3": layernorms},
               "B": {"K6": depth, "K5": depth, "K3": layernorms},
               "K1": {"K1": depth, "K3": layernorms}}
    route_logits, route_counts = {}, {}
    for name, r in routes16.items():
        route_logits[name], route_counts[name] = drive(name, r, expects[name])
        against_plain(name, route_logits[name], plain16_logits, cpu16)
    check(torch.equal(route_logits["A"], route_logits["B"]) and torch.equal(route_logits["A"], route_logits["K1"]),
          "sm16 routes A, B and K1 disagree")
    shares16 = nonzero_probability_share(art16, images[:8], dev)
    print(f"sm16 routes A, B, K1: equal logits; nonzero attention probabilities per block {shares16}; "
          f"distinct argmax over {BATCH} images {int(route_logits['A'].argmax(-1).unique().numel())}; "
          f"logit std {float(route_logits['A'].std())}")

    swin_blocks = sum(scfg["depths"])
    swin_norms = 2 * swin_blocks + len(scfg["depths"])  # two per block, one per merging, the final norm
    swin_logits, swin_counts = drive("swin", swin, {"K7": swin_blocks, "K3": swin_norms})
    swin_plain = build_swin_infer(art_swin, dev, kernels=())
    against_plain("swin", swin_logits, swin_plain(images_dev), build_swin_infer(art_swin, "cpu", kernels=())(images[:2]))
    shares_swin = swin_nonzero_probability_share(art_swin, images[:8], dev)
    print(f"non-degeneracy (swin): nonzero 8-bit window attention probabilities per block {shares_swin}; "
          f"distinct argmax over {BATCH} images {int(swin_logits.argmax(-1).unique().numel())}; "
          f"logit std {float(swin_logits.std())}")

    # 5. timing
    def engine_times(name: str, fn, plain_fn=None) -> None:
        ms128 = cuda_ms(lambda: fn(images_dev), 10)
        line = f"engine {name} batch {BATCH}: {ms128} ms/forward, {BATCH / ms128 * 1e3} images/s"
        if plain_fn is not None:
            p = cuda_ms(lambda: plain_fn(images_dev), 5)
            line += f" (plain ops: {p} ms, {BATCH / p * 1e3} images/s)"
        print(line)
        lat = []
        for i in range(60):
            t1 = time.perf_counter()
            fn(images_dev[:1])
            torch.cuda.synchronize()
            if i >= 10:
                lat.append((time.perf_counter() - t1) * 1e3)
        lat.sort()
        print(f"engine {name} batch 1: median {lat[len(lat) // 2]} ms/image, min {lat[0]}, max {lat[-1]} "
              f"(host clock, {len(lat)} runs); device {cuda_ms(lambda: fn(images_dev[:1]), 50)} ms/forward")

    engine_times("main (sm8, K1+K3+K9)", infer, plain8)
    engine_times("A (sm16, K2+K4+K3)", routes16["A"], plain16)
    engine_times("B (sm16, K6+K5+K3)", routes16["B"])
    engine_times("K1 (sm16, K1+K3)", routes16["K1"])
    engine_times("swin (Swin-T, K7+K3)", swin, swin_plain)

    timings, bounds = {}, {}
    chain_bounds = {}  # K4's, K5's, K6's and K7's bounds by the counts of the chains their tables replace
    for shape, x in k3_cases.items():
        args = (x, blk8["norm1"]["bias_int"], blk8["norm1"]["ratio"])
        timings[("K3", shape)] = paired_ms(lambda: fused_layernorm_requant(*args),
                                           lambda: fused_layernorm_requant_reference(*args), 20)
        M = x.shape[0]
        bounds[("K3", shape)] = bound_ms(M * D * 3 + 8 * D, elementwise=per_element(M * D, LAYERNORM_OPS))
    for size, ins in attn_inputs.items():
        for name, (q, k, v), a, bits, fn, ref in (
            ("K1", ins["sm8"], blk8["attn"], 8, fused_int8_attention, fused_int8_attention_reference),
            ("K2", ins["sm16"], blk16["attn"], 16, fused_int8_attention_v2, fused_int8_attention_v2_reference),
        ):
            args = (q, k, v, a["r1"], a["scale"], a["r_out"]) + ((N,) if name == "K2" else ()) + (bits,)
            shape = f"({q.shape[0]}, {N}, {hd})"
            timings[(name, shape)] = paired_ms(lambda: fn(*args), lambda: ref(*args), 20)
            G = q.shape[0]
            pv_products = 1 if bits == 8 else 2  # 16-bit probabilities: two int8 products
            bounds[(name, shape)] = bound_ms(4 * G * N * hd, int8_ops=2 * G * N * N * hd * (1 + pv_products),
                                             elementwise=per_element(G * N * N, ATTN_TABLE_OPS))
    for (size, label), (x, norm) in swin_norm_inputs.items():
        args = (x, norm["bias_int"], norm["ratio"])
        shape = f"{tuple(x.shape)} Swin-T {label}"
        timings[("K3", shape)] = paired_ms(lambda: fused_layernorm_requant(*args),
                                           lambda: fused_layernorm_requant_reference(*args), 20)
        M, C = x.shape
        bounds[("K3", shape)] = bound_ms(M * C * 3 + 8 * C, elementwise=per_element(M * C, LAYERNORM_OPS))
    for (size, i, j), (blk, (q, k, v)) in window_inputs.items():
        if j != (0 if i == len(scfg["depths"]) - 1 else 1):
            continue  # one block a stage: the masked one where the stage shifts
        a, heads = blk["attn"], blk["heads"]
        args = (q, k, v, a["bias"], a["mask"], a["r1"], a["rb"], a["scale"], a["r_out"], heads)
        shape = window_shape(q, a)
        timings[("K7", shape)] = paired_ms(lambda: fused_int8_window_attention(*args),
                                           lambda: fused_int8_window_attention_reference(*args), 20)
        G, Nw, hdw = q.shape
        planes = heads + (0 if a["mask"] is None else a["mask"].shape[0])
        mask_ops = (MASK_OPS,) if a["mask"] is not None else ()
        nbytes, products = 4 * G * Nw * hdw + 4 * planes * Nw * Nw, 4 * G * Nw * Nw * hdw
        bounds[("K7", shape)] = bound_ms(nbytes, int8_ops=products,
                                         elementwise=per_element(G * Nw * Nw, WINDOW_TABLE_OPS, *mask_ops))
        chain_bounds[("K7", shape)] = bound_ms(nbytes, int8_ops=products,
                                               elementwise=per_element(G * Nw * Nw, SHIFTMAX_OPS, WINDOW_MERGE_OPS, *mask_ops))
    for size, (x, r1, scale) in k6_inputs.items():
        shape = f"({x.shape[0]}, {N})"
        timings[("K6", shape)] = paired_ms(lambda: fused_requant_shiftmax(x, r1, scale, N),
                                           lambda: fused_requant_shiftmax_reference(x, r1, scale, N), 10)
        bounds[("K6", shape)] = bound_ms(x.numel() * 6, elementwise=per_element(x.numel(), K6_TABLE_OPS))
        chain_bounds[("K6", shape)] = bound_ms(x.numel() * 6, elementwise=per_element(x.numel(), SHIFTMAX_OPS, SPLIT_OPS))
    library = {}
    for size in x16:
        args4, args5 = k4_inputs[size], k5_inputs[size]
        M = args4[0].shape[0]
        shape4, shape5 = f"({M}, {D}) x ({D}, {hidden})", f"({M}, {hidden})"
        timings[("K4", shape4)] = paired_ms(lambda: fused_linear_shiftgelu(*args4),
                                            lambda: fused_linear_shiftgelu_reference(*args4), 10)
        bounds[("K4", shape4)] = bound_ms(M * D + D * hidden + 8 * hidden + M * hidden + 256 * 256,
                                          int8_ops=2 * M * D * hidden, elementwise=per_element(M * hidden, GELU_TABLE_OPS))
        chain_bounds[("K4", shape4)] = bound_ms(M * D + D * hidden + 8 * hidden + M * hidden,
                                                int8_ops=2 * M * D * hidden, elementwise=per_element(M * hidden, GELU_OPS))
        w = fc1["w"]
        y = args4[0] if M > 16 else torch.cat([args4[0], args4[0].new_zeros((17 - M, D))])
        library[("K4", shape4)] = cuda_ms(lambda: torch._int_mm(y, w), 20)
        timings[("K5", shape5)] = paired_ms(lambda: fused_requant_shiftgelu(*args5),
                                            lambda: fused_requant_shiftgelu_reference(*args5), 10)
        bounds[("K5", shape5)] = bound_ms(M * hidden * 5 + 4 * hidden + 256 * 256,
                                          elementwise=per_element(M * hidden, K5_TABLE_OPS))
        chain_bounds[("K5", shape5)] = bound_ms(M * hidden * 5 + 4 * hidden,
                                                elementwise=per_element(M * hidden, GELU_OPS))
    # K9 beside the plain chain the engine runs with kernels=() (bias add,
    # requant, stable ShiftGELU, requant)
    for args9 in k9_inputs.values():
        M = args9[0].shape[0]
        shape9 = f"({M}, {hidden})"
        timings[("K9", shape9)] = paired_ms(lambda: fused_requant_stable_gelu(*args9), lambda: k9_chain(*args9), 10)
        bounds[("K9", shape9)] = bound_ms(M * hidden * 5 + 8 * hidden + 256,
                                          elementwise=per_element(M * hidden, K9_TABLE_OPS))
    # K10 at ViT-L/16 at 384², batch 128, against its plain version 256
    # cells at a time
    G10, N10, hd10 = 2048, 577, 64
    shape10 = f"({G10}, {N10}, {hd10})"
    g10 = torch.Generator(device=dev).manual_seed(SEED)
    qkv10 = [torch.randint(-128, 128, (G10, N10, hd10), generator=g10, device=dev, dtype=torch.int8)
             for _ in range(3)]
    ratios10 = (float(np.float32(1 / 2000.0)), float(np.float32(1 / 40.0)), float(np.float32(1 / 300.0)))

    def k10_plain():
        return torch.cat([fused_int8_attention_long_reference(*(a[i:i + 256] for a in qkv10), *ratios10)
                          for i in range(0, G10, 256)])

    compare("K10", shape10, fused_int8_attention_long(*qkv10, *ratios10), k10_plain())
    timings[("K10", shape10)] = paired_ms(lambda: fused_int8_attention_long(*qkv10, *ratios10), k10_plain, 3)
    bounds[("K10", shape10)] = bound_ms(4 * G10 * N10 * hd10, int8_ops=4 * G10 * N10 * N10 * hd10)
    del qkv10
    for key, (k_ms, p_ms, q_ms) in timings.items():
        b, by = bounds[key]
        lib = f", torch._int_mm GEMM alone {library[key]} ms" if key in library else ""
        old = f", bound by the chain's counts {chain_bounds[key][0]} ms ({chain_bounds[key][1]})" if key in chain_bounds else ""
        print(f"{key[0]} {key[1]}: kernel {k_ms} ms (queued {q_ms} ms), plain {p_ms} ms, plain/kernel {p_ms / k_ms}, "
              f"bound {b} ms ({by}), bound/kernel {b / k_ms}{old}{lib}")
    print(f"operation counts per element (float32, int32): K7 WINDOW_TABLE_OPS {WINDOW_TABLE_OPS} + MASK_OPS "
          f"{MASK_OPS} where masked, before: SHIFTMAX_OPS {SHIFTMAX_OPS} + WINDOW_MERGE_OPS {WINDOW_MERGE_OPS}; "
          f"K4 GELU_TABLE_OPS {GELU_TABLE_OPS}, K5 K5_TABLE_OPS {K5_TABLE_OPS}, before: GELU_OPS {GELU_OPS}; "
          f"K9 K9_TABLE_OPS {K9_TABLE_OPS}; "
          f"K6 K6_TABLE_OPS {K6_TABLE_OPS}, before: SHIFTMAX_OPS {SHIFTMAX_OPS} + SPLIT_OPS {SPLIT_OPS}")

    # K3 over one batch-128 forward of each model: each launch's shape
    # timed above, times its launches a forward, beside the summed bounds
    k3_forward = {
        "DeiT-S": [(f"({BATCH * N}, {D})", 2 * depth), (f"({BATCH}, {D}) final norm", 1)],
        "Swin-T": [(f"{tuple(x.shape)} Swin-T {label}",
                    1 if label.startswith("merge") else 2 * scfg["depths"][int(label[-1]) - 1]
                    + (label == f"stage {len(scfg['depths'])}"))  # the final norm has stage 4's rows
                   for (size, label), (x, _) in swin_norm_inputs.items() if size == "b128"],
    }
    for model, launches_by_shape in k3_forward.items():
        n_launches = sum(c for _, c in launches_by_shape)
        k_sum = sum(c * timings[("K3", sh)][0] for sh, c in launches_by_shape)
        q_sum = sum(c * timings[("K3", sh)][2] for sh, c in launches_by_shape)
        b_sum = sum(c * bounds[("K3", sh)][0] for sh, c in launches_by_shape)
        print(f"K3 over one batch-{BATCH} {model} forward: {n_launches} launches, kernel {k_sum} ms "
              f"(queued {q_sum} ms), summed bound {b_sum} ms, bound/kernel {b_sum / k_sum} (queued {b_sum / q_sum})")

    def device_profile(name: str, batch: int, fn, rows: int) -> list:
        """Device time by kernel over one profiled forward, and the idle
        share: 1 − kernel time / wall time (host clock to synchronize);
        returns (ms, calls, name) by kernel name."""
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            fn(images_dev[:batch])
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t1) * 1e3
        kernels = sorted(((e.self_device_time_total / 1e3, e.count, e.key) for e in prof.key_averages()
                          if e.device_type == DeviceType.CUDA), reverse=True)
        busy = sum(k[0] for k in kernels)
        print(f"profile of one batch-{batch} forward, {name}: kernel time {busy} ms in {wall} ms wall, "
              f"idle share {1 - busy / wall}, {sum(k[1] for k in kernels)} kernels")
        for ms, calls, key in kernels[:rows]:
            print(f"  {ms} ms ({ms / busy:.4f}) {calls} calls: {key[:150]}")
        return kernels

    def k3_in_profile(model: str, kernels: list) -> None:
        ms = sum(k[0] for k in kernels if "layernorm_requant_kernel" in k[2])
        calls = sum(k[1] for k in kernels if "layernorm_requant_kernel" in k[2])
        print(f"K3 in the profiled batch-{BATCH} {model} forward: {calls} launches, {ms} ms of device time")

    k3_in_profile("DeiT-S main path", device_profile("main path", BATCH, infer, 12))
    device_profile("route A", BATCH, routes16["A"], 20)
    device_profile("route A", 1, routes16["A"], 0)
    device_profile("route B", BATCH, routes16["B"], 12)
    k3_in_profile("Swin-T", device_profile("swin (Swin-T, K7+K3)", BATCH, swin, 16))

    # 6. the serving entry points. Graphs: each path captured at batch 128
    # and 1 (deploy.graphs.capture_infer), its launches counted from 0
    # through the warm-up and both captures, its replay bit-equal to the eager
    # logits above; at batch 1, eager against graphed ms/image and idle
    graph_paths = {
        "main": (infer, logits, main_expect),
        "A": (routes16["A"], route_logits["A"], expects["A"]),
        "B": (routes16["B"], route_logits["B"], expects["B"]),
        "K1": (routes16["K1"], route_logits["K1"], expects["K1"]),
        "swin": (swin, swin_logits, {"K7": swin_blocks, "K3": swin_norms}),
        "plain": (plain8, plain8(images_dev), {}),
    }

    def host_ms(fn, x, runs: int = 40) -> float:
        """Median host ms of ``fn(x)`` to synchronize, after 5 warm calls."""
        lat = []
        for i in range(runs + 5):
            t1 = time.perf_counter()
            fn(x)
            torch.cuda.synchronize()
            if i >= 5:
                lat.append((time.perf_counter() - t1) * 1e3)
        return sorted(lat)[len(lat) // 2]

    for name, (fn, eager128, per_forward) in graph_paths.items():
        for batch in (BATCH, 1):
            for w in WRAPPERS.values():
                w.launches = 0
            t0 = time.perf_counter()
            graphed = capture_infer(fn, batch, cfg["img_size"], dev)
            capture_s = time.perf_counter() - t0
            counts = {k: w.launches for k, w in WRAPPERS.items()}
            out = graphed(images_dev[:batch])
            torch.cuda.synchronize()
            replay_counts = {k: w.launches for k, w in WRAPPERS.items()}
            print(f"graph {name} batch {batch}: captured in {capture_s:.3f} s; launches through the capture's "
                  f"{FORWARDS} forwards {counts}, in the plain capture {graphed.launches}")
            check(graphed.launches == per_forward, f"graph {name} batch {batch}: {graphed.launches} launches a forward")
            check(all(counts[k] == FORWARDS * per_forward.get(k, 0) for k in WRAPPERS),
                  f"graph {name} batch {batch}: launches {counts}")
            check(replay_counts == counts, f"graph {name} batch {batch}: a replay counted launches")
            e_graph = float((out - eager128[:batch]).abs().max())
            print(f"graph {name} batch {batch}: replay logits vs eager: max_abs_err {e_graph} (tolerance 0)")
            check(torch.equal(out, eager128[:batch]), f"graph {name} batch {batch}: replay differs from eager")
            if batch == BATCH:
                ms = cuda_ms(lambda: graphed(images_dev), 10)
                print(f"graph {name} batch {BATCH}: {ms} ms/forward, {BATCH / ms * 1e3} images/s (CUDA events)")
            else:
                x1 = images_dev[:1]
                eager_ms, graph_ms = host_ms(fn, x1), host_ms(graphed, x1)
                device_ms = cuda_ms(lambda: graphed(x1), 50, queued=True)
                print(f"graph {name} batch 1: eager {eager_ms} ms/image, graphed {graph_ms} ms/image (host clock, "
                      f"median of 40), eager/graphed {eager_ms / graph_ms}; graphed device {device_ms} ms/forward "
                      f"back to back, idle share by events {1 - device_ms / graph_ms}")
                device_profile(f"{name} eager", 1, fn, 0)
                device_profile(f"{name} graphed", 1, graphed, 0)
            del graphed, out
        torch.cuda.empty_cache()

    vit_l384_launches = vit_long_path(dev, build_vit_infer, capture_infer, FORWARDS)

    # host synchronisations inside one eager batch-128 forward of each path
    # (after a warm one): none, as a capture needs. The profiled window
    # ends in a synchronize, and the profiler synchronizes too: an empty
    # window gives the count a forward must not add to
    def host_syncs(fn) -> dict:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return {c: sum(1 for e in prof.events() if e.device_type == DeviceType.CPU and e.name == c)
                for c in SYNC_CALLS}

    empty = host_syncs(lambda: None)
    for name, (fn, _, _) in graph_paths.items():
        fn(images_dev)
        syncs = host_syncs(lambda: fn(images_dev))
        print(f"host synchronisations in one eager batch-{BATCH} forward, {name}: {syncs} (an empty window: {empty})")
        check(syncs == empty, f"{name}: the forward synchronises with the host {syncs}")

    # the FP32 leg of the benchmark, TF32 off, on the card against the CPU
    # at batch 2, on the real-scale parameters; then once with TF32 on
    fp32_art = real_scale_artifact(art8)
    fp32_card = port_bench._float_vit_infer(fp32_art, dev)
    port_bench.assert_fp32_highest()
    fp32_out = fp32_card(images_dev[:2]).cpu()
    fp32_cpu = port_bench._float_vit_infer(fp32_art, "cpu")(images[:2])
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    tf32_out = fp32_card(images_dev[:2]).cpu()
    port_bench.fp32_highest()
    tol = FP32_RTOL * float(fp32_cpu.abs().max())
    e_fp32, e_tf32 = float((fp32_out - fp32_cpu).abs().max()), float((tf32_out - fp32_cpu).abs().max())
    print(f"fp32 leg, batch 2, card vs CPU: max_abs_err {e_fp32} with TF32 off, {e_tf32} with TF32 on "
          f"(tolerance {tol}: {FP32_RTOL} x max |logit| {float(fp32_cpu.abs().max())})")
    check(e_fp32 <= tol, "fp32 leg: the card differs from the CPU beyond the float32 tolerance")
    check(e_tf32 > tol, "fp32 leg: TF32 on does not miss the tolerance, so the check cannot tell TF32 off")

    # strict_dyadic, DeiT-S at full width, batch 2: the card against the CPU
    strict_card = build_vit_infer(art8, dev, kernels=(), strict_dyadic=True)(images_dev[:2]).cpu()
    strict_cpu = build_vit_infer(art8, "cpu", kernels=(), strict_dyadic=True)(images[:2])
    print(f"strict_dyadic DeiT-S batch 2: logits card vs CPU max_abs_err {float((strict_card - strict_cpu).abs().max())} "
          f"(tolerance 0); {int((strict_card != logits[:2].cpu()).sum())} of {strict_card.numel()} logits differ from "
          "the float32-requant engine's")
    check(torch.equal(strict_card, strict_cpu), "strict_dyadic: the card differs from the CPU")

    # a reference-style DeiT-S checkpoint through convert_model, then the
    # default kernels on the card against the plain engine on the CPU
    with tempfile.TemporaryDirectory() as tmp:
        ckpt, out_path = os.path.join(tmp, "checkpoint.pth.tar"), os.path.join(tmp, "artifact.pkl")
        torch.save({"model": {k: torch.from_numpy(np.array(v)) for k, v in reference_vit_state(art8).items()}}, ckpt)
        convert_model.main(["--model", "deit_small", "--torch-checkpoint", ckpt, "--softmax-bits", "8",
                            "--gelu-stable", "--output", out_path])
        ingested = load_artifact(out_path)
    ing_infer = build_vit_infer(ingested, dev)
    for w in WRAPPERS.values():
        w.launches = 0
    ing_logits = ing_infer(images_dev[:2])
    torch.cuda.synchronize()
    ing_counts = {k: w.launches for k, w in WRAPPERS.items() if w.launches}
    ing_cpu = build_vit_infer(ingested, "cpu", kernels=())(images[:2])
    print(f"ingest: kernels {sorted(ing_infer.kernels)}, launches {ing_counts}; logits vs the plain engine on the "
          f"CPU max_abs_err {float((ing_logits.cpu() - ing_cpu).abs().max())} (tolerance 0)")
    check(ing_counts == main_expect, f"ingest: launches {ing_counts}")
    check(torch.equal(ing_logits.cpu(), ing_cpu), "ingest: the card differs from the CPU plain engine")

    # the CLIs as a user runs them
    torch.cuda.empty_cache()
    bench_lines = run_cli(["ivit_tpu_torch.bench"], 600)
    result = json.loads(bench_lines[-1])
    check(set(result) == {"metric", "value", "unit", "vs_baseline"}, f"bench: keys {sorted(result)}")
    check(all(math.isfinite(result[k]) and result[k] > 0 for k in ("value", "vs_baseline")), f"bench: {result}")
    for args, per_forward in ((["--softmax-bits", "8", "--gelu-stable"], main_expect),
                              (["--model", "swin_tiny"], {"K7": swin_blocks, "K3": swin_norms})):
        lines = run_cli(["ivit_tpu_torch.evaluate_latency", *args], 300)
        check(re.match(r"^\S+ int8 batch=1: [0-9.]+ ms/iter, [0-9.]+ img/s$", lines[-1]) is not None,
              f"evaluate_latency {args}: last line {lines[-1]!r}")
        captured = re.search(r"launches a forward (\{.*\})", "\n".join(lines))
        check(captured is not None and ast.literal_eval(captured.group(1)) == per_forward,
              f"evaluate_latency {args}: launches a forward {captured and captured.group(1)}")

    # 7. the trainer
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    library_step_ms = trainer_phase(dev)
    print(f"trainer phase: {time.perf_counter() - t0:.3f} s; chip_smoke so far {time.perf_counter() - t_main:.3f} s")

    # 8. the Swin trainer
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    swin_trainer_phase(dev)
    print(f"swin trainer phase: {time.perf_counter() - t0:.3f} s; chip_smoke so far "
          f"{time.perf_counter() - t_main:.3f} s")

    # 9. the trainer's entry points
    torch.cuda.empty_cache()
    cli_phase(dev, library_step_ms)
    print(f"chip_smoke so far {time.perf_counter() - t_main:.3f} s")

    # 10. pretrained import and the float models
    torch.cuda.empty_cache()
    pretrained_phase(dev)
    print(f"chip_smoke so far {time.perf_counter() - t_main:.3f} s")

    # 11. the recompute, and the serialized engines over the kernels' operators
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    remat_phase(dev)
    print(f"remat phase: {time.perf_counter() - t0:.3f} s; chip_smoke so far {time.perf_counter() - t_main:.3f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    export_phase(dev, {
        "main": (infer, main_expect),
        "A": (routes16["A"], expects["A"]),
        "B": (routes16["B"], expects["B"]),
        "strict": (path_engine("strict", dev), {}),
        "swin": (swin, {"K7": swin_blocks, "K3": swin_norms}),
    }, images)
    print(f"export phase: {time.perf_counter() - t0:.3f} s; chip_smoke so far {time.perf_counter() - t_main:.3f} s")

    # 12. multi-GPU on the one card
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    nccl_world_of_one(dev)
    torch.cuda.empty_cache()
    mesh_kernels = mesh_phase(smi, {
        "art8": art8, "art16": art16, "swin": art_swin, "images": images.numpy(),
        "ref": {"main": logits.cpu(), "B": route_logits["B"].cpu(), "swin": swin_logits.cpu()},
    })
    print(f"multi-GPU phase: {time.perf_counter() - t0:.3f} s; chip_smoke so far {time.perf_counter() - t_main:.3f} s")

    # 13. tensor-parallel QAT on the one card
    torch.cuda.empty_cache()
    tpq_kernels = tpq_phase(smi)
    print(f"chip_smoke so far {time.perf_counter() - t_main:.3f} s")

    # 14. the GPipe pipeline on the one card
    torch.cuda.empty_cache()
    pp_kernels = pp_phase(smi)
    print(f"chip_smoke so far {time.perf_counter() - t_main:.3f} s")

    big = {"K1": f"({BATCH * H}, {N}, {hd})", "K2": f"({BATCH * H}, {N}, {hd})",
           "K3": f"({BATCH * N}, {D})", "K4": f"({BATCH * N}, {D}) x ({D}, {hidden})",
           "K5": f"({BATCH * N}, {hidden})", "K6": f"({BATCH * H * N}, {N})",
           "K7": window_shape(window_inputs[("b128", 0, 1)][1][0], window_inputs[("b128", 0, 1)][0]["attn"]),
           "K9": f"({BATCH * N}, {hidden})", "K10": "(2048, 577, 64)"}
    sources = {"K1": ("attention_fused.cu", "kernels/attention_fused.py:126"),
               "K2": ("attention_fused_v2.cu", "kernels/attention_fused_v2.py:140"),
               "K3": ("intnorm_fused.cu", "kernels/intnorm_fused.py:74"),
               "K4": ("linear_gelu_fused.cu", "kernels/linear_gelu_fused.py:87"),
               "K5": ("shiftgelu_fused.cu", "kernels/shiftgelu_fused.py:79"),
               "K6": ("shiftmax_fused.cu", "kernels/shiftmax_fused.py:95"),
               "K7": ("window_attention_fused.cu", "kernels/window_attention_fused.py:132"),
               "K9": ("stable_gelu_fused.cu", "deploy/engine.py (the stable-GELU epilogue as XLA ops)"),
               "K10": ("attention_long.cu", "deploy/engine.py:227-237 (the XLA attention above 256 tokens)")}
    launches = {"K1": main_counts["K1"], "K3": main_counts["K3"], "K2": route_counts["A"]["K2"],
                "K4": route_counts["A"]["K4"], "K5": route_counts["B"]["K5"], "K6": route_counts["B"]["K6"],
                "K7": swin_counts["K7"], "K9": main_counts["K9"],
                "K10": vit_l384_launches["K10"]}  # ViT-L/16 at 384², phase 6
    tp2_launches = {"K1": depth, "K3": layernorms, "K5": depth, "K6": depth, "K7": swin_blocks, "K9": depth}
    record = {"kernels": []}
    for name, fn in WRAPPERS.items():
        key = (name, big[name])
        src, tpu = sources[name]
        record["kernels"].append({
            "name": f"{name} {fn.__name__}", "route": "cuda",
            "source": f"ivit_tpu_torch/csrc/{src}", "replaces": f"ivit_tpu/{tpu}",
            "launches": launches[name], "max_abs_err": errs[name],
            "ms": timings[key][0], "queued_ms": timings[key][2], "plain_ms": timings[key][1],
            "bound_ms": bounds[key][0], "bound_by": bounds[key][1],
            "library_ms": library.get(key),
            # phase 12: the kernel on one rank's inputs at TP=2 (K7 at each
            # stage), its launches a forward there
            "tp2": [dict(kr, stage=k, launches=tp2_launches.get(name)) for k, kr in mesh_kernels.items()
                    if k.split()[0] == name] or None,
            # phase 13: the kernel on rank 0's inputs of the frozen TP-trained
            # model served at TP=2, its launches a forward there
            "tp2_trained": [dict(kr, stage=k) for k, kr in tpq_kernels.items() if k.split()[0] == name] or None,
            # phase 14: the kernel on the pipe-trained model's inputs, served
            # whole on one process, its launches a forward there
            "pipe_trained": pp_kernels.get(name),
        })
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
