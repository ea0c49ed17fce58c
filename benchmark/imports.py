"""The modules a run of the port may not hold: JAX, its compiler, flax and
the JAX package. A module counts by its top-level name (before the first
dot) compared whole, so ``ivit_tpu_torch`` passes and ``ivit_tpu`` fails."""

from __future__ import annotations

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "ivit_tpu"})


def forbidden_modules(modules) -> list:
    """The forbidden top-level names among ``modules``' names, sorted."""
    return sorted({name.split(".", 1)[0] for name in modules} & FORBIDDEN)
