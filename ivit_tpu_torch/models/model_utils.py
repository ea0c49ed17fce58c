"""Model state utilities: the evaluation variables and the scale report.

Counterpart of ``ivit_tpu/models/model_utils.py``. A model's variables
here are two flat dicts of tensors keyed by torch name: ``params`` (its
parameters) and ``quant_stats`` (its ``QuantAct`` ranges, the buffers
``min_val`` and ``max_val``). ``torch.func.functional_call`` runs the
model on them (``train.steps.make_eval_step``).
"""

from __future__ import annotations

import torch

from ..core.quantizers import symmetric_scale


def model_variables(model: torch.nn.Module) -> dict:
    """The live ``{"params", "quant_stats"}`` of ``model`` (not copies)."""
    return {"params": dict(model.named_parameters()), "quant_stats": dict(model.named_buffers())}


def eval_variables(state, use_ema: bool = True) -> dict:
    """Variables for frozen-range evaluation: the EMA weights when the
    state carries them, else the live parameters, with the live ranges."""
    variables = model_variables(state.model)
    if use_ema and state.ema_params is not None:
        variables["params"] = dict(state.ema_params)
    return variables


def scale_report(variables: dict, bits: int = 8) -> dict:
    """Every EMA range in ``quant_stats`` as ``{module path: (min, max,
    scale)}`` (the path in flax's form, ``blocks_0/attn/qact1``), the
    scale at ``bits`` as JAX's report computes it."""
    stats = variables["quant_stats"]
    out = {}
    for name, t in stats.items():
        mod, leaf = name.rsplit(".", 1)
        if leaf != "min_val":
            continue
        mn, mx = t.detach().cpu(), stats[f"{mod}.max_val"].detach().cpu()
        out[mod.replace(".", "/")] = (float(mn), float(mx), float(symmetric_scale(mn, mx, bits)))
    return out
