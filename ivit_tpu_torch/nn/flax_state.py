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


def flatten(tree: dict, prefix: str = "") -> dict:
    """Nested dicts as one dict keyed by the ``.``-joined paths."""
    out = {}
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, dict):
            out.update(flatten(value, name + "."))
        else:
            out[name] = value
    return out


def nest(flat: dict) -> dict:
    """The inverse of ``flatten``."""
    out: dict = {}
    for name, value in flat.items():
        *path, leaf = name.split(".")
        node = out
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = value
    return out


def named_tree(names: list, tensors: list) -> dict:
    """Tensors keyed by torch name as nested dicts of numpy copies."""
    return nest({n: t.detach().cpu().numpy().copy() for n, t in zip(names, tensors)})


def load_named_tree(tensors: list, names: list, tree: dict, what: str) -> None:
    """Copy ``tree`` (``named_tree``'s layout) into ``tensors`` in place;
    raises ``KeyError`` unless both hold the same names and
    ``ValueError`` on a shape or dtype that differs."""
    flat = flatten(tree)
    if set(flat) != set(names):
        raise KeyError(f"{what}: only in flax's tree {sorted(set(flat) - set(names))}, "
                       f"only in torch {sorted(set(names) - set(flat))}")
    with torch.no_grad():
        for name, t in zip(names, tensors):
            a = np.asarray(flat[name])
            if a.shape != tuple(t.shape) or a.dtype != np.dtype(str(t.dtype).split(".")[-1]):
                raise ValueError(f"{what} {name}: flax {a.dtype}{a.shape}, torch {t.dtype}{tuple(t.shape)}")
            t.copy_(torch.from_numpy(np.array(a)))


def load_flax_variables(model: torch.nn.Module, variables: dict) -> torch.nn.Module:
    """Copy JAX's ``variables`` (nested dicts of arrays) into ``model``'s
    parameters and buffers, in place; raises ``KeyError`` unless the two
    hold the same names and ``ValueError`` on a shape or dtype that
    differs. Returns ``model``."""
    from ..models.model_utils import model_variables

    for coll, named in model_variables(model).items():
        load_named_tree(list(named.values()), list(named), variables.get(coll, {}), coll)
    return model


def flax_variables(model: torch.nn.Module) -> dict:
    """``model``'s parameters and buffers as JAX's ``variables``: nested
    dicts of numpy arrays (the inverse of ``load_flax_variables``)."""
    from ..models.model_utils import model_variables

    return {coll: named_tree(list(named), list(named.values())) for coll, named in model_variables(model).items()}
