"""Carry variables between a flax model and its torch counterpart.

JAX's variables are ``{"params": ..., "quant_stats": ...}``, nested dicts
of arrays keyed by module name. The port's modules keep flax's names, so
a leaf's flax path joined by ``.`` is its torch name: parameters for
``params``, ``QuantAct`` buffers for ``quant_stats``. Every array keeps
its shape and dtype (float32 throughout: a ``QuantLinear`` kernel is
``(in, out)`` on both sides).
"""

from __future__ import annotations

import numpy as np
import torch

_COLLECTIONS = ("params", "quant_stats")


def _flatten(tree: dict, prefix: str = "") -> dict:
    out = {}
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, dict):
            out.update(_flatten(value, name + "."))
        else:
            out[name] = value
    return out


def _nest(flat: dict) -> dict:
    out: dict = {}
    for name, value in flat.items():
        *path, leaf = name.split(".")
        node = out
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = value
    return out


def load_flax_variables(model: torch.nn.Module, variables: dict) -> torch.nn.Module:
    """Copy JAX's ``variables`` (nested dicts of arrays) into ``model``'s
    parameters and buffers, in place; raises ``KeyError`` unless the two
    hold the same names and ``ValueError`` on a shape or dtype that
    differs. Returns ``model``."""
    from ..models.model_utils import model_variables

    ours = model_variables(model)
    for coll in _COLLECTIONS:
        theirs = _flatten(variables.get(coll, {}))
        if set(theirs) != set(ours[coll]):
            raise KeyError(f"{coll}: only in flax {sorted(set(theirs) - set(ours[coll]))}, "
                           f"only in torch {sorted(set(ours[coll]) - set(theirs))}")
        with torch.no_grad():
            for name, t in ours[coll].items():
                a = np.asarray(theirs[name])
                if a.shape != tuple(t.shape) or a.dtype != np.dtype(str(t.dtype).split(".")[-1]):
                    raise ValueError(f"{coll} {name}: flax {a.dtype}{a.shape}, torch {t.dtype}{tuple(t.shape)}")
                t.copy_(torch.from_numpy(np.array(a)))
    return model


def flax_variables(model: torch.nn.Module) -> dict:
    """``model``'s parameters and buffers as JAX's ``variables``: nested
    dicts of numpy arrays (the inverse of ``load_flax_variables``)."""
    from ..models.model_utils import model_variables

    return {coll: _nest({n: t.detach().cpu().numpy().copy() for n, t in named.items()})
            for coll, named in model_variables(model).items()}
