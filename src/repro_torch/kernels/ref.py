"""Plain PyTorch versions of the kernels (the allclose targets).

They compute what the reference's Pallas kernels compute: q, k and v cast
to fp32, products and softmax in fp32, the output cast to q's dtype. That
is not what ``models.layers.sdpa`` computes at bf16 (it keeps scores in
q's dtype), so a kernel is held against these, never against ``sdpa``.

Used by the CPU tests, by ``chip_smoke.py``'s comparisons, and by the
``kernels.ops`` wrappers for tensors that lie on the CPU.
"""

from __future__ import annotations

import math

import torch

from repro_torch.serve.paged import gather_kv

NEG_INF = -1e30


def flash_decode(q, k, v, lengths):
    """Ragged single-token GQA decode: q (b, h, d) vs k/v (b, skv, kvh, d).

    Slot i attends its first ``lengths[i]`` rows; a zero-length slot gives
    zeros (a freed engine slot). Port of ``repro.kernels.ref.flash_decode``.
    """
    b, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    group = h // kvh
    qg = q.reshape(b, kvh, group, d).float()
    s = torch.einsum("bhgd,bkhd->bhgk", qg, k.float()) / math.sqrt(d)
    lengths = lengths.to(s.device).long()
    valid = torch.arange(skv, device=s.device)[None, :] < lengths[:, None]
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", p, v.float())
    out = torch.where((lengths > 0)[:, None, None, None], out,
                      torch.zeros_like(out))
    return out.reshape(b, h, d).to(q.dtype)


def flash_decode_paged(q, k_pages, v_pages, page_table, lengths):
    """Paged decode: ``gather_kv`` through the table, then ``flash_decode``.

    Lengths past the table's reach see only the ``max_pages * page_size``
    rows the table maps, as the TPU kernel does."""
    kc, vc = gather_kv(k_pages, v_pages, page_table)
    return flash_decode(q, kc, vc, lengths)


def flash_attention_paged(q, k_pages, v_pages, page_table, starts):
    """Causal chunk attention through a page table.

    q: (b, sq, h, d); query r of slot i sits at ``starts[i] + r`` and
    attends every mapped row ``<= starts[i] + r`` (the chunk's own rows
    are already written: write-then-attend). The table maps at most
    ``max_pages * page_size`` rows, which bounds a chunk that runs past
    the end of the table."""
    b, sq, h, d = q.shape
    kvh = k_pages.shape[2]
    group = h // kvh
    kc, vc = gather_kv(k_pages, v_pages, page_table)
    skv = kc.shape[1]
    qg = q.reshape(b, sq, kvh, group, d).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kc.float()) / math.sqrt(d)
    pos = (starts.to(s.device).long()[:, None]
           + torch.arange(sq, device=s.device)[None, :])          # (b, sq)
    cols = torch.arange(skv, device=s.device)
    mask = cols[None, None, :] <= pos[:, :, None]                 # (b, sq, skv)
    s = torch.where(mask[:, None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, vc.float())
    return out.reshape(b, sq, h, d).to(q.dtype)


# How far a kernel may sit from its plain version, per dtype, as
# (atol, rtol): fp32 leaves only summation order (1e-4 absolute); bf16
# output may also round to the neighbouring value, one bf16 step (2**-7
# relative, 8 significand bits) — fp32 results a hair apart can straddle
# a rounding boundary.
TOLERANCE = {torch.float32: (1e-4, 0.0), torch.bfloat16: (1e-3, 2.0 ** -7)}


def compare(got: torch.Tensor, want: torch.Tensor):
    """(within tolerance, max absolute error) of a kernel's output
    against its plain version's."""
    atol, rtol = TOLERANCE[want.dtype]
    err = (got.float() - want.float()).abs()
    ok = bool((err <= atol + rtol * want.float().abs()).all())
    return ok, float(err.max()) if err.numel() else 0.0
