"""Hand-written CUDA kernels (``csrc/``) behind torch wrappers.

Each wrapper checks its inputs, runs its plain torch version for CPU
tensors, launches the kernel for CUDA tensors (or raises), and counts
its launches in a ``launches`` attribute. Importing this package builds
nothing: the library is compiled at the first CUDA launch.
"""

from .attention_fused import fused_int8_attention, fused_int8_attention_reference
from .intnorm_fused import fused_layernorm_requant, fused_layernorm_requant_reference

__all__ = [
    "fused_int8_attention",
    "fused_int8_attention_reference",
    "fused_layernorm_requant",
    "fused_layernorm_requant_reference",
]
