"""Launcher of the CUDA GEMM kernels (``csrc/gemm.cu``).

Replaces ``repro/kernels/gemm.py:gemm`` (the Pallas ``_gemm_kernel``). Two
engines, by input type: fp32 runs the paper's Ch.1 register-tile GEMM on
the CUDA cores (one CTA per (bm, bn) output tile looping over k, an 8 x 8
fp32 register tile a thread); bf16 runs wgmma on the tensor cores, fed by
TMA where the rows allow it (k and n multiples of 8) and by the producer
warp's element loads otherwise. ``TILES`` are the (bm, bk, bn) tiles the
build instantiates for each dtype; ``core.autotune`` chooses among them.
``kernels.ops.gemm`` checks the arguments and counts launches; call that,
not this.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_decode import DTYPES

TILES = {torch.float32: ((64, 16, 64), (128, 16, 128)),
         torch.bfloat16: ((128, 64, 128), (128, 64, 256))}
# Shared-memory stages of the bf16 kernel's ring (kTcStages in gemm.cu).
TC_STAGES = 4
# Threads of a bf16 CTA: two consumer warpgroups and the producer warp
# (kTcThreads); an fp32 CTA has one thread an 8 x 8 register tile.
TC_THREADS = 2 * 128 + 32
# Registers a thread of each tile's kernel holds, as ptxas reports them for
# sm_90a (``chip_smoke.py`` phase 1 prints them and fails if they differ):
# the fp32 kernel with vector loads, the bf16 kernel (either loader).
REGISTERS = {torch.float32: {(64, 16, 64): 165, (128, 16, 128): 129},
             torch.bfloat16: {(128, 64, 128): 90, (128, 64, 256): 154}}
# The engine and loader a launch ran, as the C entry point reports them.
PATHS = ("cuda cores", "wgmma + TMA", "wgmma + element loads")
last_path = None


def gemm(x, y, out, block) -> None:
    """Launch on the current stream; raise if the launch fails. The path
    that ran (one of ``PATHS``) is kept as ``last_path``."""
    global last_path
    lib = _build.load()
    (m, k), n = x.shape, y.shape[1]
    bm, bk, bn = block
    path = ctypes.c_int(-1)
    err = lib.blocked_gemm(
        DTYPES[x.dtype], bm, bk, bn, x.data_ptr(), y.data_ptr(),
        out.data_ptr(), m, k, n, ctypes.byref(path),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gemm launch failed: error {err}")
    last_path = PATHS[path.value]
