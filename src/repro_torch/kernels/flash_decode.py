"""Launchers of the CUDA decode kernel (``csrc/paged_attention.cu``).

One kernel body, two ways to find a slot's K/V rows:

* ``paged_decode`` replaces ``repro/kernels/flash_decode.py:flash_decode_paged``
  (the Pallas ``_paged_decode_kernel``): rows through a page table;
* ``contiguous_decode`` replaces ``repro/kernels/flash_decode.py:flash_decode``
  (the Pallas ``_decode_kernel``): rows of a contiguous (b, max_len, kvh, d)
  cache.

Single-token GQA decode, one CTA per (slot, kv head). ``kernels.ops``
checks the arguments and counts launches; call that, not these.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 80, 128)


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: error {err}")


def paged_decode(q, k_pages, v_pages, page_table, lengths, out) -> None:
    """Launch on the current stream; raise if the launch fails."""
    lib = _build.load()
    b, h, d = q.shape
    _, page_size, kvh, _ = k_pages.shape
    _raise_on(lib.paged_decode(
        DTYPES[q.dtype], d, q.data_ptr(), k_pages.data_ptr(),
        v_pages.data_ptr(), page_table.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), b, h, kvh, page_size, page_table.shape[1],
        torch.cuda.current_stream(q.device).cuda_stream), "paged_decode")


def contiguous_decode(q, k, v, lengths, out) -> None:
    """Launch on the current stream; raise if the launch fails."""
    lib = _build.load()
    b, h, d = q.shape
    _, max_len, kvh, _ = k.shape
    _raise_on(lib.contiguous_decode(
        DTYPES[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), b, h, kvh, max_len,
        torch.cuda.current_stream(q.device).cuda_stream),
        "contiguous_decode")
