"""Launchers of the CUDA decode kernels (``csrc/paged_attention.cu``).

One kernel body, two ways to find a slot's K/V rows:

* ``paged_decode`` replaces ``repro/kernels/flash_decode.py:flash_decode_paged``
  (the Pallas ``_paged_decode_kernel``): rows through a page table;
* ``contiguous_decode`` replaces ``repro/kernels/flash_decode.py:flash_decode``
  (the Pallas ``_decode_kernel``): rows of a contiguous (b, max_len, kvh, d)
  cache.

Single-token GQA decode, flash-decoding's design: each slot's context is
cut into splits of ``rows_per_split`` rows (the decode's tile, one of
``SPLIT_ROWS_SET`` rounded to whole pages), one CTA per (kv head, slot,
split), and the last of a slot's splits to finish merges their fp32
partials in split order; the contiguous decode's merge can also write
each query row's log-sum-exp (``lse``: the sequence-parallel decode
combines ranks' partial attention with it). ``splits`` sizes the grid
from the cache's shape alone, so a launch reads nothing of ``lengths``
on the host. ``kernels.ops``
checks the arguments and counts launches; call that, not these.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from repro_torch.kernels import _build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 80, 96, 128)
# The split lengths a launch takes (the decode's counterpart of the
# reference's key block: the unit of the cache one CTA walks), each rounded
# to whole pages; any positive length runs, so none is a template of the
# build. SPLIT_ROWS is the one every decode ran before the chooser
# (``core.autotune.choose_attn_block``) picked among them.
SPLIT_ROWS_SET = (128, 256, 512)
SPLIT_ROWS = 256
# The split kernel's tile (csrc/paged_attention.cu): a CTA takes a query
# block of QUERY_BLOCK[dtype] rows of one kv head's group (``G`` of
# ``dispatch_decode``: 16 rows on the tensor cores, 8 on the CUDA cores;
# padded past the group), and each warp scores WARP_ROWS key rows a step
# (``kWarpRows``). ``core.autotune`` prices these tiles.
QUERY_BLOCK = {torch.bfloat16: 16, torch.float32: 8}
WARP_ROWS = 16
THREADS = 128      # a CTA's 4 warps (``kDecThreads``)


def split_rows(rows: int, page_size: int = 1) -> int:
    """A split of about ``rows`` rows in whole pages (at least one)."""
    return max(1, rows // page_size) * page_size


def splits(max_rows: int, page_size: int = 1,
           rows: int = SPLIT_ROWS) -> Tuple[int, int]:
    """(rows_per_split, n_splits) for a cache whose slots reach at most
    ``max_rows`` rows (``max_pages * page_size``, or ``max_len``): runs of
    about ``rows`` rows in whole pages that together cover ``max_rows``.
    Shapes only: a slot's length decides at run time which splits have
    rows, never how many there are."""
    rows = split_rows(rows, page_size)
    return rows, max(1, -(-max_rows // rows))


# Zeroed int32 counters kept per (device, stream) and shared by the kernels
# that hand work on between CTAs of one launch: the decodes' merge counts
# (one per (slot, query block)) and the SSD scan's tickets and counts. Each
# launch leaves the ints it used at zero (the last CTA to use one resets
# it), so launches in order on one stream share them. A CUDA graph captured
# on a stream holds the address of that stream's buffer, so a buffer that
# is outgrown is kept in ``_OUTGROWN``, never freed.
_COUNTERS: Dict[Tuple[torch.device, int], torch.Tensor] = {}
_OUTGROWN: List[torch.Tensor] = []


def _partials(q, n_splits: int) -> torch.Tensor:
    """fp32 scratch of the splits' (acc, m, l): b * h * n_splits * (d + 2)."""
    b, h, d = q.shape
    return torch.empty(b * h * n_splits * (d + 2), dtype=torch.float32,
                       device=q.device)


def zeroed_ints(device, stream: int, need: int) -> torch.Tensor:
    """At least ``need`` zeroed int32 counters for launches on ``stream``."""
    key = (device, stream)
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < need:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "the kernels' zeroed counters for a capture stream must "
                "exist before the capture: run the step on that stream "
                "once first")
        if buf is not None:
            _OUTGROWN.append(buf)
        buf = _COUNTERS[key] = torch.zeros(need, dtype=torch.int32,
                                           device=device)
    return buf


def _counters(q, stream: int) -> torch.Tensor:
    """The merge's b * h zeroed counters for launches on ``stream``."""
    return zeroed_ints(q.device, stream, q.shape[0] * q.shape[1])


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: error {err}")


def paged_decode(q, k_pages, v_pages, page_table, lengths, out,
                 rows: int = SPLIT_ROWS) -> None:
    """Launch on the current stream, in splits of about ``rows`` rows;
    raise if the launch fails."""
    lib = _build.load()
    b, h, d = q.shape
    _, page_size, kvh, _ = k_pages.shape
    max_pages = page_table.shape[1]
    rows, n_splits = splits(max_pages * page_size, page_size, rows)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    part, counters = _partials(q, n_splits), _counters(q, stream)
    _raise_on(lib.paged_decode(
        DTYPES[q.dtype], d, q.data_ptr(), k_pages.data_ptr(),
        v_pages.data_ptr(), page_table.data_ptr(), lengths.data_ptr(),
        part.data_ptr(), counters.data_ptr(), out.data_ptr(), b, h, kvh,
        page_size, max_pages, rows, n_splits, stream), "paged_decode")


def contiguous_decode(q, k, v, lengths, out, lse=None,
                      rows: int = SPLIT_ROWS) -> None:
    """Launch on the current stream, in splits of ``rows`` rows; raise if
    the launch fails. ``lse``: None, or an fp32 (b, h) tensor the merge
    writes each row's log-sum-exp into."""
    lib = _build.load()
    b, h, d = q.shape
    _, max_len, kvh, _ = k.shape
    rows, n_splits = splits(max_len, 1, rows)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    part, counters = _partials(q, n_splits), _counters(q, stream)
    _raise_on(lib.contiguous_decode(
        DTYPES[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        lengths.data_ptr(), part.data_ptr(), counters.data_ptr(),
        out.data_ptr(), None if lse is None else lse.data_ptr(), b, h, kvh,
        max_len, rows, n_splits, stream), "contiguous_decode")
