"""Launcher of the CUDA SSD scan kernel (``csrc/ssd_scan.cu``).

Replaces ``repro/kernels/ssd_scan.py:ssd_scan`` (the Pallas ``_ssd_kernel``):
the chunked Mamba-2 scan, one CTA per (batch row, head) looping over
chunks of ``CHUNK`` rows with the (p, n) state carried in shared memory.
``kernels.ops.ssd_scan`` checks the arguments and counts launches; call
that, not this.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_decode import DTYPES

CHUNK = 128
SHAPES = ((64, 128),)       # (head_dim p, d_state n) the build instantiates


def ssd_scan(x, a_log, b, c, h0, y, state) -> None:
    """Launch on the current stream; raise if the launch fails. ``h0``
    None starts from a zero state."""
    lib = _build.load()
    bt, l, h, p = x.shape
    err = lib.ssd_scan(
        DTYPES[x.dtype], p, b.shape[-1], x.data_ptr(), a_log.data_ptr(),
        b.data_ptr(), c.data_ptr(), None if h0 is None else h0.data_ptr(),
        y.data_ptr(), state.data_ptr(), bt, l, h,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan launch failed: error {err}")
