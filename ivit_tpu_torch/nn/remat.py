"""Per-block recompute for the QAT models (JAX's ``nn.remat``).

Counterpart of ``nn.remat(Block)`` and ``nn.remat(SwinBlock)``
(``ivit_tpu/models/vit.py:116-136``, ``ivit_tpu/models/swin.py:336-357``):
a block keeps only its input for the backward and runs its forward again
there to rebuild what autograd saved. ``torch.utils.checkpoint``
(non-reentrant: the saved-tensor hooks, so autograd ``Function``s such as
the exact dots keep their saved tensors, and the ``QTensor`` carrier
passes whole) does the recompute; two effects that JAX's functional
remat does not have are undone in the re-run:

* a ``QuantAct`` moves its range in place under ``update_stats``. The
  re-run holds every range of the block (``nn.quant.held_ranges``), so it
  reads the buffers as the forward's one update left them: the range the
  forward quantized with, since each ``QuantAct`` runs once a forward;
* dropout and stochastic depth draw from the caller's ``generator``, which
  has moved on by the time the backward runs. The re-run draws from a
  copy set to the generator's state before the block, so it draws the
  same masks, and the caller's generator ends where it would without
  the recompute. The global generators (``generator=None``) are replayed
  by ``checkpoint`` itself (``preserve_rng_state``);
* the backward runs outside the step's ``nn.quant.data_shard``. The
  re-run enters the shard the forward ran in, so a data-parallel block
  draws its rows of the global masks again and a tensor-parallel one
  finds its context; its collectives run in the same order on every
  rank, since every rank recomputes the same blocks.

Without gradients (an eval forward, ``torch.no_grad``) there is nothing
to recompute and the block runs as it is.
"""

from __future__ import annotations

import contextlib

import torch
from torch.utils.checkpoint import checkpoint

from ..core.qtensor import QTensor
from .quant import current_shard, data_shard, held_ranges


def remat(block: torch.nn.Module, x: QTensor, train: bool, generator: torch.Generator | None) -> QTensor:
    """``block(x, train, generator)``, its activations recomputed in the
    backward with its ranges held and its random draws replayed."""
    if not torch.is_grad_enabled():
        return block(x, train, generator)
    state = None if generator is None else generator.get_state()
    draws = [generator]
    shard = current_shard()

    @contextlib.contextmanager
    def recompute():
        if state is not None:
            replay = torch.Generator(device=generator.device)
            replay.set_state(state)
            draws[0] = replay
        with held_ranges(block), data_shard(shard):
            yield

    return checkpoint(lambda x: block(x, train, draws[0]), x, use_reentrant=False,
                      context_fn=lambda: (contextlib.nullcontext(), recompute()))
