"""ivit_tpu_torch: the PyTorch + CUDA (Hopper) port of ``ivit_tpu``.

The JAX package ``ivit_tpu`` stays the reference; this package mirrors
its module paths and function names so each counterpart is easy to find:

* ``core/``    — scale computation (``symmetric_scale``, ``weight_scale``),
  the straight-through estimators and the quantizer, ``QTensor``, and
  the dyadic requantization of strict mode.
* ``ops/``     — the integer-op spec on torch tensors (shift-exp,
  Shiftmax, ShiftGELU, I-LayerNorm, requantization), run plain
  (``DEPLOY``) or with straight-through gradients (``SIM``), and the
  exact int8 GEMM at any shape. Runs on any device and is what every
  kernel is checked against.
* ``nn/``      — the QAT layers and ViT blocks, and the carry-over of a
  flax model's variables.
* ``train/``   — losses, the learning-rate schedule, AdamW, the train
  state and the train and eval steps.
* ``kernels/`` — wrappers around the hand-written CUDA kernels in
  ``csrc/`` (K1–K7: fused attention, window attention, Shiftmax,
  ShiftGELU and I-LayerNorm chains, on the shared K0 Shiftmax header),
  each beside its plain torch version.
* ``deploy/``  — freezing a trained ViT, the frozen-artifact carry-overs,
  seeded synthetic artifacts, the integer-only ViT and Swin inference engines, their
  capture as CUDA graphs, and the ingester of the reference's trained
  checkpoints.
* ``models/``  — the ViT/DeiT and Swin configuration tables, Swin's
  window geometry, and the QAT ``VisionTransformer`` (``create_model``).
* ``utils/``   — artifact pickling.
* ``bench``, ``evaluate_latency``, ``convert_model`` — the serving CLIs,
  run as ``python -m ivit_tpu_torch.<name>``.

Nothing here imports JAX, flax, optax or ``ivit_tpu``.
"""
