"""Build and load the port's CUDA kernels.

Counterpart of ``ivit_tpu/native/build.py``: ``nvcc`` compiles every
``csrc/*.cu`` for Hopper (``sm_90a``) into one shared library with a
plain C interface, which is loaded with ``ctypes``. It builds at first
use into ``build/`` at the repository root (listed in ``.gitignore``)
and rebuilds when a source or header is newer than the library.

The flags are part of the numerics: ``-fmad=false`` keeps nvcc from
contracting ``a*b+c`` into one FMA (which rounds once instead of twice),
and fast-math stays off so float32 ``/`` is correctly rounded. Both are
needed for the integer-carrier f32 chains to match the spec bit for bit.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import tempfile

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build")
LIB = os.path.join(BUILD_DIR, "libivit_tpu_torch_kernels.so")
SOURCES = ("attention_fused.cu", "intnorm_fused.cu")
HEADERS = ("shiftmax_common.cuh",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# name -> argtypes of each C entry point (all return cudaError_t as int)
_ENTRY_POINTS = {
    # q, k, v, out, G, N, hd, r1, scale, r_out, n, out_bits, stream
    "ivit_fused_int8_attention": (_P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _I, _I, _P),
    # x, bias_int, ratio, out, M, C, stream
    "ivit_fused_layernorm_requant": (_P, _P, _P, _P, _I, _I, _P),
}


def nvcc_path() -> str:
    """``nvcc`` from ``PATH``, else from ``$CUDA_HOME`` or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(home, "bin", "nvcc")


def nvcc_command(out_path: str = LIB, nvcc: str | None = None) -> list[str]:
    """The nvcc command line that builds the kernel library."""
    srcs = [os.path.join(CSRC, s) for s in SOURCES]
    return [nvcc or nvcc_path(), *NVCC_FLAGS, "-o", out_path, *srcs]


def _stale() -> bool:
    if not os.path.exists(LIB):
        return True
    built = os.path.getmtime(LIB)
    return any(
        os.path.getmtime(os.path.join(CSRC, f)) > built for f in SOURCES + HEADERS
    )


def build(force: bool = False) -> str:
    """Compile the kernels if the library is missing or stale; returns its
    path. The library is written under a temporary name and renamed, so a
    concurrent loader never sees a partial file."""
    if not force and not _stale():
        return LIB
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = nvcc_command(tmp)
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, LIB)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return LIB


@functools.cache
def load() -> ctypes.CDLL:
    """Build if needed, then load the library once per process."""
    lib = ctypes.CDLL(build())
    for name, argtypes in _ENTRY_POINTS.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")
