"""Hand-written CUDA kernels (``csrc/``) behind torch wrappers.

Each wrapper checks its inputs, runs its plain torch version for CPU
tensors, launches the kernel for CUDA tensors (or raises), and counts
its launches in a ``launches`` attribute. Importing this package builds
nothing: the libraries are compiled at the first CUDA launch.
"""

from .attention_fused import fused_int8_attention, fused_int8_attention_reference
from .attention_fused_v2 import fused_int8_attention_v2, fused_int8_attention_v2_reference
from .intnorm_fused import fused_layernorm_requant, fused_layernorm_requant_reference
from .linear_gelu_fused import fused_linear_shiftgelu, fused_linear_shiftgelu_reference
from .shiftgelu_fused import fused_requant_shiftgelu, fused_requant_shiftgelu_reference
from .shiftmax_fused import fused_requant_shiftmax, fused_requant_shiftmax_reference
from .window_attention_fused import fused_int8_window_attention, fused_int8_window_attention_reference

# every kernel wrapper, by the name of its TPU kernel's number
WRAPPERS = {
    "K1": fused_int8_attention,
    "K2": fused_int8_attention_v2,
    "K3": fused_layernorm_requant,
    "K4": fused_linear_shiftgelu,
    "K5": fused_requant_shiftgelu,
    "K6": fused_requant_shiftmax,
    "K7": fused_int8_window_attention,
}

__all__ = [
    "WRAPPERS",
    "fused_int8_attention",
    "fused_int8_attention_reference",
    "fused_int8_attention_v2",
    "fused_int8_attention_v2_reference",
    "fused_int8_window_attention",
    "fused_int8_window_attention_reference",
    "fused_layernorm_requant",
    "fused_layernorm_requant_reference",
    "fused_linear_shiftgelu",
    "fused_linear_shiftgelu_reference",
    "fused_requant_shiftgelu",
    "fused_requant_shiftgelu_reference",
    "fused_requant_shiftmax",
    "fused_requant_shiftmax_reference",
]
