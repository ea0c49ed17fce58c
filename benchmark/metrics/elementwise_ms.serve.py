"""Device ms a forward in kernels that are neither GEMMs (the names of
``gemm_ms.serve``) nor the port's own ``csrc`` kernels: the engines'
plain tensor ops, elementwise chains and copies alike."""

import re

from benchmark import spec

PORT = re.compile(
    r"attention_mma_kernel|fused_layernorm_requant_kernel|window_attention_kernel|fused_linear_shiftgelu_kernel"
    r"|gelu_table_kernel|fused_requant_shiftgelu_kernel|fused_requant_shiftmax_kernel"
)


def read(view):
    gemm = spec.load_module("metrics", "gemm_ms.serve", view.cell.root).GEMM
    total = sum(s for name, s in view.kernels() if not PORT.search(name) and not gemm.search(name))
    if view.units <= 0 or total <= 0:
        return None
    return 1e3 * total / view.units
