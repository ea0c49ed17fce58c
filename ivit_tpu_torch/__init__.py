"""ivit_tpu_torch: the PyTorch + CUDA (Hopper) port of ``ivit_tpu``.

The JAX package ``ivit_tpu`` stays the reference; this package mirrors
its module paths and function names so each counterpart is easy to find:

* ``core/``    — scale computation (``symmetric_scale``, ``weight_scale``).
* ``ops/``     — the integer-op DEPLOY spec on torch tensors (shift-exp,
  Shiftmax, ShiftGELU, I-LayerNorm, requantization). Runs on any device
  and is what every kernel is checked against.
* ``kernels/`` — wrappers around the hand-written CUDA kernels in
  ``csrc/`` (K1 fused attention, K3 fused I-LayerNorm → requant, and the
  shared K0 Shiftmax header), each beside its plain torch version.
* ``deploy/``  — the frozen-artifact carry-over, a seeded synthetic
  artifact builder, and the integer-only ViT inference engine.
* ``models/``  — the ViT/DeiT configuration table.
* ``utils/``   — artifact pickling.

Nothing here imports JAX, flax, optax or ``ivit_tpu``.
"""
