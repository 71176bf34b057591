"""Launchers of the CUDA prefill kernel (``csrc/paged_attention.cu``).

One CTA per (batch row, q head, ``block_q`` query rows, one of
``BLOCK_QS``); the body multiplies bf16
on the tensor cores (mma.sync) and fp32 on the CUDA cores (the tensor
cores take fp32 only as TF32). Each body has two ways to find the K/V
rows:

* ``paged_prefill`` replaces
  ``repro/kernels/flash_attention.py:flash_attention_paged`` (the Pallas
  ``_paged_prefill_kernel``): causal chunk attention through a page table;
* ``flash_attention`` replaces
  ``repro/kernels/flash_attention.py:flash_attention`` (the Pallas
  ``_flash_kernel``): full-sequence GQA attention, causal or not, over
  contiguous (b, skv, kvh, d) K/V, the causal diagonal offset by skv - sq.

``kernels.ops`` checks the arguments and counts launches; call that, not
these.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_decode import DTYPES

# The body's tiles (``PrefillBlockQs``, ``kTileK`` in
# csrc/paged_attention.cu): a CTA takes block_q query rows, one of the
# instantiated BLOCK_QS (padded with zeros past sq), and walks the keys
# TILE_K rows a step. ``core.autotune`` prices and chooses among them.
BLOCK_QS = (16, 64)
TILE_K = 64


def paged_prefill(q, k_pages, v_pages, page_table, starts, out,
                  block_q: int) -> None:
    """Launch on the current stream; raise if the launch fails."""
    lib = _build.load()
    b, sq, h, d = q.shape
    _, page_size, kvh, _ = k_pages.shape
    err = lib.paged_prefill(
        DTYPES[q.dtype], d, q.data_ptr(), k_pages.data_ptr(),
        v_pages.data_ptr(), page_table.data_ptr(), starts.data_ptr(),
        out.data_ptr(), b, sq, h, kvh, page_size, page_table.shape[1],
        block_q, torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_prefill launch failed: error {err}")


def flash_attention(q, k, v, causal: bool, out, block_q: int) -> None:
    """Launch on the current stream; raise if the launch fails."""
    lib = _build.load()
    b, sq, h, d = q.shape
    _, skv, kvh, _ = k.shape
    err = lib.flash_attention(
        DTYPES[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), b, sq, skv, h, kvh, int(causal), block_q,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: error {err}")
