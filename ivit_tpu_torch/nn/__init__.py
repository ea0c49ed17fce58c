from .flax_state import flax_variables, load_flax_variables
from .quant import (
    IntGELU,
    IntLayerNorm,
    IntSoftmax,
    QuantAct,
    QuantLinear,
    QuantPatchEmbed,
    exact_int8_dot,
    exact_int8_dot_bias,
    exact_int_matmul,
    quant_matmul,
)
from .vit_blocks import Attention, Block, Mlp, drop_path, quant_dropout

__all__ = [
    "Attention",
    "Block",
    "IntGELU",
    "IntLayerNorm",
    "IntSoftmax",
    "Mlp",
    "QuantAct",
    "QuantLinear",
    "QuantPatchEmbed",
    "drop_path",
    "exact_int8_dot",
    "exact_int8_dot_bias",
    "exact_int_matmul",
    "flax_variables",
    "load_flax_variables",
    "quant_dropout",
    "quant_matmul",
]
