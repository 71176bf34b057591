"""Build the CUDA kernels with ``nvcc`` at first use and load them with ctypes.

Every ``csrc/*.cu`` has a plain C interface (no PyTorch headers), so each
compiles in seconds. The sources are compiled in parallel, one ``nvcc``
per source, and linked into one library under ``build/kernels/<hash>/`` at
the root of the checkout, keyed by a hash of the sources, their headers
and the compiler flags: an edited source rebuilds, an unchanged one is
loaded as it is. Nothing is built when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C signatures: (dtype, sizes..., pointers..., ints..., stream) -> cudaError_t
# (_L: a 64-bit long long);
# blocked_gemm also takes an int* it writes the path that ran to.
SIGNATURES = {
    "paged_decode": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                     _I, _I, _I, _I, _I, _I, _I, _P],
    "contiguous_decode": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                          _I, _I, _I, _I, _I, _I, _P],
    "paged_prefill": [_I, _I, _P, _P, _P, _P, _P, _P,
                      _I, _I, _I, _I, _I, _I, _I, _P],
    "flash_attention": [_I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                        _P],
    "ssd_scan": [_I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                 _P],
    "blocked_gemm": [_I, _I, _I, _I, _P, _P, _P, _I, _I, _I, _P, _P],
    "pchase": [_P, _P, _I, _P],
    "pchase_timed": [_P, _P, _P, _P, _P, _L, _L, _L, _I, _I, _I, _P],
}

_LIB: Optional[ctypes.CDLL] = None


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


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
    key = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        key.update(f.name.encode() + f.read_bytes())
    out = BUILD_ROOT / key.hexdigest()[:16] / "libkernels.so"
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tag = os.getpid()
    objs = [out.parent / f"{src.stem}.{tag}.o" for src in sources()]
    procs = [subprocess.Popen([nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj),
                               str(src)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(sources(), objs)]
    logs = [p.communicate()[0] for p in procs]
    (out.parent / "build.log").write_text("".join(logs))
    for src, proc, log in zip(sources(), procs, logs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src.name}:\n{log}")
    tmp = out.with_suffix(f".{tag}.tmp")
    link = subprocess.run([nvcc(), *ARCH_FLAGS, "-shared", "-o", str(tmp),
                           *map(str, objs)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    for obj in objs:
        obj.unlink()
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
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
