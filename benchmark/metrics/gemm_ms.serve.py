"""Device ms a forward in the int8 GEMMs (``torch._int_mm`` through
``ops/intmm.py``): cuBLAS's and CUTLASS's GEMM kernels, by name."""

import re

GEMM = re.compile(r"gemm|xmma|cutlass|wmma|imma", re.IGNORECASE)


def read(view):
    total = sum(s for name, s in view.kernels() if GEMM.search(name))
    if view.units <= 0 or total <= 0:
        return None
    return 1e3 * total / view.units
