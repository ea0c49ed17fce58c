"""Build and load the port's CUDA kernels.

Counterpart of ``ivit_tpu/native/build.py``: ``nvcc`` compiles each
``csrc/*.cu`` for Hopper (``sm_90a``) into its own shared library with a
plain C interface, which is loaded with ``ctypes``. The compilers run in
parallel, one process per source, all started together. Libraries are
built at first use into ``build/`` at the repository root (listed in
``.gitignore``), and one is rebuilt when its source or any header is
newer than it.

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
import types

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build")
HEADERS = ("shiftmax_common.cuh", "attention_mma.cuh", "gelu_common.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# source -> {C entry point: argtypes}; every entry point returns cudaError_t as int
_ENTRY_POINTS = {
    "attention_fused.cu": {
        # q, k, v, out, G, N, hd, r1, scale, r_out, n, out_bits, stream
        "ivit_fused_int8_attention": (_P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _I, _I, _P),
    },
    "attention_long.cu": {
        # q, k, v, out, G, N, hd, r1, scale, r_out, n, out_bits, stream
        "ivit_fused_int8_attention_long": (_P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _I, _I, _P),
    },
    "attention_fused_v2.cu": {
        # q, k, v, out, G, N, hd, r1, scale, r_out, n, out_bits, stream
        "ivit_fused_int8_attention_v2": (_P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _I, _I, _P),
    },
    "intnorm_fused.cu": {
        # x, bias_int, ratio, out, M, C, stream
        "ivit_fused_layernorm_requant": (_P, _P, _P, _P, _I, _I, _P),
    },
    "shiftgelu_fused.cu": {
        # x, r1, table, out, M, C, stream
        "ivit_fused_requant_shiftgelu": (_P, _P, _P, _P, _I, _I, _P),
    },
    "linear_gelu_fused.cu": {
        # x, w_t, b, r1, table, out, M, K, C, stream
        "ivit_fused_linear_shiftgelu": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
        # table, s_in, r2, n, stream
        "ivit_gelu_table": (_P, _F, _F, _I, _P),
    },
    "stable_gelu_fused.cu": {
        # x, b, r1, table, out, M, C, stream
        "ivit_fused_requant_stable_gelu": (_P, _P, _P, _P, _P, _I, _I, _P),
    },
    "shiftmax_fused.cu": {
        # x, hi, lo, M, N, n_valid, r1, scale, n, out_bits, stream
        "ivit_fused_requant_shiftmax": (_P, _P, _P, _I, _I, _I, _F, _F, _I, _I, _P),
    },
    "window_attention_fused.cu": {
        # q, k, v, bias, mask (or None), out, G, N, hd, heads, n_windows, r1, rb, scale, r_out, n, stream
        "ivit_fused_int8_window_attention": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _F, _F, _I, _P),
    },
}
SOURCES = tuple(_ENTRY_POINTS)


def lib_path(source: str) -> str:
    """The shared library built from ``csrc/<source>``."""
    return os.path.join(BUILD_DIR, f"libivit_{os.path.splitext(source)[0]}.so")


def nvcc_path() -> str:
    """``nvcc`` from ``PATH``, else from ``$CUDA_HOME`` or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(home, "bin", "nvcc")


def nvcc_command(source: str, out_path: str, nvcc: str | None = None) -> list[str]:
    """The nvcc command line that builds ``source`` into ``out_path``."""
    return [nvcc or nvcc_path(), *NVCC_FLAGS, "-o", out_path, os.path.join(CSRC, source)]


def _stale(source: str) -> bool:
    lib = lib_path(source)
    if not os.path.exists(lib):
        return True
    built = os.path.getmtime(lib)
    return any(os.path.getmtime(os.path.join(CSRC, f)) > built for f in (source, *HEADERS))


def build(force: bool = False) -> list[str]:
    """Compile every missing or stale library, all nvcc processes at once;
    returns the library paths. Each library is written under a temporary
    name and renamed, so a concurrent loader never sees a partial file."""
    todo = [s for s in SOURCES if force or _stale(s)]
    os.makedirs(BUILD_DIR, exist_ok=True)
    jobs = []
    try:
        for source in todo:
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = nvcc_command(source, tmp)
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            jobs.append((source, tmp, cmd, proc))
        failed = []
        for source, tmp, cmd, proc in jobs:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}")
            else:
                os.replace(tmp, lib_path(source))
        if failed:
            raise RuntimeError("\n".join(failed))
    finally:
        for _, tmp, _, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.remove(tmp)
    return [lib_path(s) for s in SOURCES]


@functools.cache
def load() -> types.SimpleNamespace:
    """Build if needed, then load every library once per process; returns
    the C entry points as attributes."""
    build()
    fns = {}
    for source, entry_points in _ENTRY_POINTS.items():
        lib = ctypes.CDLL(lib_path(source))
        for name, argtypes in entry_points.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            fns[name] = fn
    return types.SimpleNamespace(**fns)


def check(err: int, name: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")
