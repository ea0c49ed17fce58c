"""Checkpoints of the QAT train state, in the JAX package's format.

Counterpart of ``ivit_tpu/utils/checkpoint.py:20-35``, ``:113-127`` and
``:163-173``. A checkpoint is a pickle (protocol 4) of
``{"state": state dict, "extra": {...}}``, where the state dict is what
flax's ``to_state_dict`` makes of JAX's ``TrainState``, numpy arrays
throughout:

* ``step``: int32;
* ``params`` and ``quant_stats``: nested by flax path (the port's
  modules keep flax's names, ``nn.flax_state``);
* ``opt_state``: optax's layout (``AdamW.state_dict``, ``SGD.state_dict``);
* ``ema_params``: nested like ``params``, or None without an EMA.

So a checkpoint either package writes loads into the other: JAX's
``load_checkpoint(path, target)`` takes the port's file, and the port's
``load_checkpoint`` takes JAX's. Files are written to ``path + ".tmp"``
and moved into place. Paths are local: unpickling runs code from the
file, so load only checkpoints this project wrote. JAX's download of
http(s) checkpoints and its orbax variants are not ported; the artifact
half of the JAX module is ``utils.artifact``.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from ..nn.flax_state import flax_variables, load_flax_variables, load_named_tree, named_tree


def _local(path: str) -> str:
    if "://" in path:
        raise ValueError(f"checkpoint {path!r}: only local paths are read (no download); copy the file here first")
    return path


def _param_names(model: torch.nn.Module) -> list:
    return [n for n, _ in model.named_parameters()]


def train_state_dict(state) -> dict:
    """The train state (``train.TrainState``) as JAX's checkpoint holds it."""
    names = _param_names(state.model)
    variables = flax_variables(state.model)
    ema = None if state.ema_params is None else named_tree(names, [state.ema_params[n] for n in names])
    return {
        "step": np.asarray(state.step, np.int32),
        "params": variables["params"],
        "quant_stats": variables["quant_stats"],
        "opt_state": state.tx.state_dict(state.opt_state, names),
        "ema_params": ema,
    }


def load_train_state(state, tree: dict):
    """Read a checkpoint's state dict into ``state`` in place (on its
    model's device); raises ``KeyError`` or ``ValueError`` where the two
    differ in names, shapes or whether they hold an EMA."""
    names = _param_names(state.model)
    load_flax_variables(state.model, {"params": tree["params"], "quant_stats": tree["quant_stats"]})
    state.tx.load_state_dict(state.opt_state, names, tree["opt_state"])
    if (tree.get("ema_params") is None) != (state.ema_params is None):
        raise ValueError("the checkpoint and the train state differ in holding an EMA of the parameters "
                         f"(checkpoint: {tree.get('ema_params') is not None})")
    if state.ema_params is not None:
        load_named_tree([state.ema_params[n] for n in names], names, tree["ema_params"], "ema_params")
    state.step = int(tree["step"])
    return state


def save_checkpoint(path: str, state, extra: dict | None = None) -> None:
    """Write ``state`` (a ``train.TrainState``) and ``extra`` to ``path``,
    atomically."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    payload = {"state": train_state_dict(state), "extra": extra or {}}
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(payload, f, protocol=4)
    os.replace(tmp, path)


def load_checkpoint(path: str, target):
    """Restore into ``target`` (a ``train.TrainState``, in place); returns
    ``(state, extra)``."""
    raw, extra = load_checkpoint_raw(path)
    return load_train_state(target, raw), extra


def load_checkpoint_raw(path: str):
    """The raw nested state dict and ``extra`` (no target needed)."""
    with open(_local(path), "rb") as f:
        payload = pickle.load(f)
    return payload["state"], payload.get("extra", {})
