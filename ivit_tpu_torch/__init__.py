"""ivit_tpu_torch: the PyTorch + CUDA (Hopper) port of ``ivit_tpu``.

The JAX package ``ivit_tpu`` stays the reference; this package mirrors
its module paths and function names so each counterpart is easy to find:

* ``core/``    — scale computation (``symmetric_scale``, ``weight_scale``).
* ``ops/``     — the integer-op DEPLOY spec on torch tensors (shift-exp,
  Shiftmax, ShiftGELU, I-LayerNorm, requantization). Runs on any device
  and is what every kernel is checked against.
* ``kernels/`` — wrappers around the hand-written CUDA kernels in
  ``csrc/`` (K1–K7: fused attention, window attention, Shiftmax,
  ShiftGELU and I-LayerNorm chains, on the shared K0 Shiftmax header),
  each beside its plain torch version.
* ``deploy/``  — the frozen-artifact carry-overs, seeded synthetic
  artifacts, and the integer-only ViT and Swin inference engines.
* ``models/``  — the ViT/DeiT and Swin configuration tables and Swin's
  window geometry.
* ``utils/``   — artifact pickling.

Nothing here imports JAX, flax, optax or ``ivit_tpu``.
"""
