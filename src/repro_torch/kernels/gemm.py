"""Launcher of the CUDA blocked GEMM kernel (``csrc/gemm.cu``).

Replaces ``repro/kernels/gemm.py:gemm`` (the Pallas ``_gemm_kernel``): the
paper's Ch.1 register-tile GEMM, one CTA per (bm, bn) output tile looping
over k with an 8 x 8 fp32 register tile a thread. ``TILES`` are the
(bm, bk, bn) tiles the build instantiates; ``core.autotune`` chooses among
them. ``kernels.ops.gemm`` checks the arguments and counts launches; call
that, not this.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_decode import DTYPES

TILES = ((64, 16, 64), (128, 16, 128))


def gemm(x, y, out, block) -> None:
    """Launch on the current stream; raise if the launch fails."""
    lib = _build.load()
    (m, k), n = x.shape, y.shape[1]
    bm, bk, bn = block
    err = lib.blocked_gemm(
        DTYPES[x.dtype], bm, bk, bn, x.data_ptr(), y.data_ptr(),
        out.data_ptr(), m, k, n,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gemm launch failed: error {err}")
