"""Hand-written CUDA kernels (``csrc/``) behind torch wrappers.

Each wrapper checks its inputs (shapes, dtypes, strides: what a fake
tensor has too) and calls its operator, ``ivit::<wrapper name>``, a
``torch.library.custom_op`` with a fake implementation, so that
``torch.export`` records each kernel as one node of the graph
(``deploy.export``). The operator runs the plain torch version for CPU
tensors and launches the kernel for CUDA tensors (or raises: a check
that needs real memory, such as an alignment, lies there), and counts
its launches in the wrapper's ``launches`` attribute, whoever calls it:
the wrapper or a reloaded exported program. Importing this package
registers the operators and builds nothing: the libraries are compiled
at the first CUDA launch.
"""

from .attention_fused import fused_int8_attention, fused_int8_attention_reference
from .attention_fused_v2 import fused_int8_attention_v2, fused_int8_attention_v2_reference
from .intnorm_fused import fused_layernorm_requant, fused_layernorm_requant_reference
from .linear_gelu_fused import fused_linear_shiftgelu, fused_linear_shiftgelu_reference
from .shiftgelu_fused import fused_requant_shiftgelu, fused_requant_shiftgelu_reference
from .shiftmax_fused import fused_requant_shiftmax, fused_requant_shiftmax_reference
from .stable_gelu_fused import fused_requant_stable_gelu, fused_requant_stable_gelu_reference, stable_gelu_table
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
    "K9": fused_requant_stable_gelu,  # the port's own: no TPU kernel (K8 is the GEMMs' XLA epilogues)
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
    "fused_requant_stable_gelu",
    "fused_requant_stable_gelu_reference",
    "stable_gelu_table",
]
