"""Build the CUDA kernels with ``nvcc`` at first use and load them with ctypes.

``csrc/paged_attention.cu`` has a plain C interface (no PyTorch headers),
so one ``nvcc`` call takes seconds. The library lands in
``build/kernels/<hash>/`` at the root of the checkout, keyed by a hash of
the source and the compiler flags, so an edited source rebuilds and an
unchanged one is loaded as it is. Nothing is built when this module is
imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

SOURCE = Path(__file__).resolve().parent / "csrc" / "paged_attention.cu"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I = ctypes.c_void_p, ctypes.c_int
# C signatures: (dtype, d, pointers..., ints..., stream) -> cudaError_t.
SIGNATURES = {
    "paged_decode": [_I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "paged_prefill": [_I, _I, _P, _P, _P, _P, _P, _P,
                      _I, _I, _I, _I, _I, _I, _P],
}

_LIB: Optional[ctypes.CDLL] = None


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return path


def build() -> Path:
    """Compile the kernels unless their library is already built. The
    compiler's resource report (``-Xptxas -v``) is kept beside the library
    as ``build.log``."""
    key = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode())
    out = BUILD_ROOT / key.hexdigest()[:16] / "libpaged_attention.so"
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    (out.parent / "build.log").write_text(proc.stdout)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {SOURCE.name}:\n{proc.stdout}")
    os.replace(tmp, out)   # atomic: a concurrent loader sees all or nothing
    return out


def load() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        for fn, argtypes in SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _LIB = lib
    return _LIB
