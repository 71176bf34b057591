"""Public wrappers of the paged-attention kernels.

Same arguments and layouts as ``repro/kernels/ops.py``'s
``flash_decode_paged`` / ``flash_attention_paged``; block sizes are the
CUDA kernels' own constants. A tensor on the CPU goes to the plain version
(``kernels.ref``); a CUDA tensor goes to the kernel, or the wrapper raises.
There is no fallback from one to the other.

``LAUNCHES`` counts kernel launches, one per call that reached the kernel;
the plain versions never touch it.
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import flash_attention as _prefill
from repro_torch.kernels import flash_decode as _decode
from repro_torch.kernels import ref

LAUNCHES: Dict[str, int] = {"flash_decode_paged": 0,
                            "flash_attention_paged": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check(q, k_pages, v_pages, page_table, lens, q_rank: int) -> None:
    """Raise on anything the kernels do not take. Shared by both paths,
    so the CPU tests exercise the same contract the card enforces."""
    if q.dim() != q_rank or k_pages.dim() != 4:
        raise ValueError(f"q rank {q.dim()} (want {q_rank}), pool rank "
                         f"{k_pages.dim()} (want 4)")
    if k_pages.shape != v_pages.shape:
        raise ValueError(f"k/v pools differ: {tuple(k_pages.shape)} vs "
                         f"{tuple(v_pages.shape)}")
    b, h, d = q.shape[0], q.shape[-2], q.shape[-1]
    kvh = k_pages.shape[2]
    if k_pages.shape[3] != d or h % kvh:
        raise ValueError(f"q heads/dim ({h}, {d}) vs pool kv heads/dim "
                         f"({kvh}, {k_pages.shape[3]})")
    if page_table.dim() != 2 or page_table.shape[0] != b \
            or tuple(lens.shape) != (b,):
        raise ValueError(f"page_table {tuple(page_table.shape)} / lengths "
                         f"{tuple(lens.shape)} do not match batch {b}")
    devs = {t.device for t in (q, k_pages, v_pages, page_table, lens)}
    if len(devs) != 1:
        raise ValueError(f"arguments on several devices: {devs}")
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError(f"pool dtype {k_pages.dtype} != q dtype {q.dtype}")
    if q.device.type == "cpu":
        return
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    if q.dtype not in _decode.DTYPES:
        raise TypeError(f"kernel takes float32/bfloat16, got {q.dtype}")
    if d not in _decode.HEAD_DIMS:
        raise ValueError(f"kernel takes head_dim in {_decode.HEAD_DIMS}, "
                         f"got {d}")
    if page_table.dtype != torch.int32 or lens.dtype != torch.int32:
        raise TypeError("page_table and lengths/starts must be int32")
    for t in (q, k_pages, v_pages, page_table, lens):
        if not t.is_contiguous():
            raise ValueError("kernel arguments must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError("kernel arguments must be 16-byte aligned")


def flash_decode_paged(q, k_pages, v_pages, page_table, lengths):
    """Paged GQA decode: q (b, h, d) vs a (n_pages, page_size, kvh, d)
    pool walked through ``page_table`` (b, max_pages); slot i attends its
    first ``lengths[i]`` rows (0 gives zeros). Returns (b, h, d)."""
    _check(q, k_pages, v_pages, page_table, lengths, 3)
    if q.device.type == "cpu":
        return ref.flash_decode_paged(q, k_pages, v_pages, page_table,
                                      lengths)
    out = torch.empty_like(q)
    if q.shape[0]:
        _decode.paged_decode(q, k_pages, v_pages, page_table, lengths, out)
        LAUNCHES["flash_decode_paged"] += 1
    return out


def flash_attention_paged(q, k_pages, v_pages, page_table, starts):
    """Causal chunk attention against a paged pool: q (b, sq, h, d) at
    global positions ``starts[i] + [0, sq)``; the chunk's own K/V rows
    must already be written through the table. Returns (b, sq, h, d)."""
    _check(q, k_pages, v_pages, page_table, starts, 4)
    if q.device.type == "cpu":
        return ref.flash_attention_paged(q, k_pages, v_pages, page_table,
                                         starts)
    out = torch.empty_like(q)
    if q.shape[0] and q.shape[1]:
        _prefill.paged_prefill(q, k_pages, v_pages, page_table, starts, out)
        LAUNCHES["flash_attention_paged"] += 1
    return out
