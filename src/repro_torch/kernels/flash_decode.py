"""Launcher of the CUDA paged-decode kernel (``csrc/paged_attention.cu``).

Replaces ``repro/kernels/flash_decode.py:flash_decode_paged`` (the Pallas
``_paged_decode_kernel``): single-token GQA decode through a page table,
one CTA per (slot, kv head). ``kernels.ops.flash_decode_paged`` checks the
arguments and counts launches; call that, not this.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 80, 128)


def paged_decode(q, k_pages, v_pages, page_table, lengths, out) -> None:
    """Launch on the current stream; raise if the launch fails."""
    lib = _build.load()
    b, h, d = q.shape
    _, page_size, kvh, _ = k_pages.shape
    err = lib.paged_decode(
        DTYPES[q.dtype], d, q.data_ptr(), k_pages.data_ptr(),
        v_pages.data_ptr(), page_table.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), b, h, kvh, page_size, page_table.shape[1],
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_decode launch failed: error {err}")
