from .interp import DEPLOY, SIM, Interp
from .intnorm import int_layernorm
from .requant import INT8, INT16, requant, requantize
from .shiftexp import int_exp_shift
from .shiftgelu import shiftgelu
from .shiftmax import shiftmax

__all__ = [
    "DEPLOY",
    "SIM",
    "Interp",
    "INT8",
    "INT16",
    "int_exp_shift",
    "int_layernorm",
    "requant",
    "requantize",
    "shiftgelu",
    "shiftmax",
]
