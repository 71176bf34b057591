"""Plain PyTorch versions of the kernels (the allclose targets).

They compute what the reference's Pallas kernels compute: inputs cast to
fp32, products, softmax and the scan in fp32, the output cast to the
input's dtype. That is not what ``models.layers.sdpa`` computes at bf16
(it keeps scores in q's dtype), so a kernel is held against these, never
against ``sdpa``.

Used by the CPU tests, by ``chip_smoke.py``'s comparisons, and by the
``kernels.ops`` wrappers for tensors that lie on the CPU.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.serve.paged import gather_kv

NEG_INF = -1e30


def flash_attention(q, k, v, causal: bool = True):
    """Full-sequence GQA attention: q (b, sq, h, d) vs k/v (b, skv, kvh, d),
    scores and softmax in fp32 scaled by 1/sqrt(d), the output in q's
    dtype. Causal: query i attends keys ``<= i + skv - sq`` (the diagonal
    offset when skv > sq). Port of ``repro.kernels.ref.flash_attention``."""
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    group = h // kvh
    qg = q.reshape(b, sq, kvh, group, d).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) / math.sqrt(d)
    if causal:
        mask = torch.ones(sq, skv, dtype=torch.bool,
                          device=s.device).tril(diagonal=skv - sq)
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return out.reshape(b, sq, h, d).to(q.dtype)


def flash_decode(q, k, v, lengths, return_lse: bool = False):
    """Ragged single-token GQA decode: q (b, h, d) vs k/v (b, skv, kvh, d).

    Slot i attends its first ``lengths[i]`` rows; a zero-length slot gives
    zeros (a freed engine slot). Port of ``repro.kernels.ref.flash_decode``.
    ``return_lse`` also returns each row's log-sum-exp of its scaled
    scores, fp32 (b, h), -inf for a zero-length slot."""
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
    live = (lengths > 0)[:, None, None]
    out = torch.where(live[..., None], out, torch.zeros_like(out))
    out = out.reshape(b, h, d).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(live, torch.logsumexp(s, dim=-1),
                      torch.full_like(s[..., 0], -math.inf))
    return out, lse.reshape(b, h)


def flash_decode_split(q, k, v, lengths, rows_per_split: int):
    """``flash_decode`` computed the way the CUDA decode cuts it: the
    context in runs of ``rows_per_split`` rows, each run's fp32 partial
    (running max m, denominator l, unnormalised acc) over its live rows,
    the partials merged in split order by log-sum-exp. A split at or past
    a slot's length (clamped to the cache's ``skv`` rows) is empty
    (m = NEG_INF, l = 0) and weighs nothing; a slot with no live split
    gives zeros. A model of the kernel for the tests, not a plain version
    the wrappers route to."""
    b, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    group = h // kvh
    qg = q.reshape(b, kvh, group, d).float()
    n = lengths.to(q.device).long().clamp(0, skv)
    parts = []
    for s0 in range(0, max(skv, 1), rows_per_split):
        kk = k[:, s0:s0 + rows_per_split].float()
        vv = v[:, s0:s0 + rows_per_split].float()
        s = torch.einsum("bhgd,bkhd->bhgk", qg, kk) / math.sqrt(d)
        live = (s0 + torch.arange(kk.shape[1], device=q.device))[None] \
            < n[:, None]
        s = torch.where(live[:, None, None], s, torch.full_like(s, NEG_INF))
        m = s.amax(-1) if s.shape[-1] else torch.full(
            s.shape[:-1], NEG_INF, device=q.device)
        p = torch.where(live[:, None, None], torch.exp(s - m[..., None]),
                        torch.zeros_like(s))
        parts.append((m, p.sum(-1), torch.einsum("bhgk,bkhd->bhgd", p, vv)))
    mx = torch.stack([torch.where(l > 0, m, torch.full_like(m, NEG_INF))
                      for m, l, _ in parts]).amax(0)
    lsum = torch.zeros_like(mx)
    acc = torch.zeros_like(parts[0][2])
    for m, l, a in parts:                               # split order
        w = torch.where(l > 0, torch.exp(m - mx), torch.zeros_like(m))
        lsum = lsum + w * l
        acc = acc + w[..., None] * a
    out = acc / torch.where(lsum > 0, lsum, torch.ones_like(lsum))[..., None]
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


def ssd_scan(x, a_log, b, c, h0=None, chunk: int = 128):
    """Chunked SSD scan at a fixed ``chunk``, the last chunk masked: l is
    padded up to a multiple of the chunk with x = 0, a = 0 and B = C = 0
    rows (they neither decay nor feed the state), run through the chunked
    algorithm in fp32 (``models.mamba.ssd_chunked``) and cropped.

    x (bt, l, h, p); a_log (bt, l, h) fp32; b, c (bt, l, n) shared by all
    heads; h0 (bt, h, p, n) fp32 or None (zeros). Returns y (bt, l, h, p)
    in x's dtype and the final state (bt, h, p, n) in fp32."""
    from repro_torch.models.mamba import ssd_chunked

    l = x.shape[1]
    pad = -l % chunk
    y, state = ssd_chunked(
        F.pad(x.float(), (0, 0, 0, 0, 0, pad)),
        F.pad(a_log.float(), (0, 0, 0, pad)),
        F.pad(b.float(), (0, 0, 0, pad)), F.pad(c.float(), (0, 0, 0, pad)),
        chunk, h0=None if h0 is None else h0.float())
    return y[:, :l].to(x.dtype), state


def gemm(x, y):
    """(m, k) @ (k, n) with an fp32 accumulator, rounded once to x's dtype:
    what the reference's Pallas ``gemm`` computes (its fp32 VMEM
    accumulator, cast at the last k step), not ``repro/kernels/ref.py``'s
    ``gemm``, which accumulates in the input dtype. fp32 inputs stay in
    full fp32 on the card while ``torch.backends.cuda.matmul.allow_tf32``
    is False (PyTorch's default)."""
    return (x.float() @ y.float()).to(x.dtype)


def pchase(chain, steps: int):
    """Follow the int32 next-index ``chain`` from position 0 for ``steps``
    dependent loads; returns the visited positions (int32, on the chain's
    device). A loop on the host, as ``repro/kernels/ref.py``'s ``pchase``."""
    nxt = chain.cpu().numpy()
    out = np.empty(steps, dtype=np.int32)
    pos = 0
    for i in range(steps):
        out[i] = pos
        pos = int(nxt[pos])
    return torch.from_numpy(out).to(chain.device)


def pchase_timed(chain, steps: int, start: int = 0, warm: int = 0):
    """The offsets ``pchase_timed`` visits: from byte offset ``start``
    through the int64 byte-offset ``chain`` (slot ``pos // 8`` holds the
    next offset), ``warm`` steps unrecorded, then ``steps`` recorded (int64,
    on the chain's device). A loop on the host, as
    ``simulator.MemoryHierarchy.chase`` walks; the kernel's cycles have no
    plain counterpart. Raises, as the kernel's wrapper does, on an offset
    outside the chain, negative or not a multiple of 8."""
    nxt = chain.cpu().numpy()
    n_bytes = 8 * nxt.size

    def follow(pos: int) -> int:
        v = int(nxt[pos // 8])
        if not 0 <= v < n_bytes or v % 8:
            raise ValueError("pchase_timed met an offset outside the chain, "
                             "negative or not a multiple of 8")
        return v

    pos = start
    for _ in range(warm):
        pos = follow(pos)
    out = np.empty(steps, dtype=np.int64)
    for i in range(steps):
        out[i] = pos
        pos = follow(pos)
    return torch.from_numpy(out).to(chain.device)


# How far a kernel may sit from its plain version, per dtype, as
# (atol, rtol): fp32 leaves only summation order (1e-4 absolute); bf16
# output may also round to the neighbouring value, one bf16 step (2**-7
# relative, 8 significand bits) — fp32 results a hair apart can straddle
# a rounding boundary.
TOLERANCE = {torch.float32: (1e-4, 0.0), torch.bfloat16: (1e-3, 2.0 ** -7)}


def compare(got: torch.Tensor, want: torch.Tensor, normwise: bool = False):
    """(within tolerance, max absolute error) of a kernel's output against
    its plain version's.

    ``normwise`` scales the absolute tolerance by the output's magnitude,
    max(1, max |want|). The SSD scan is compared so: its outputs are sums
    of decayed terms, not convex combinations of its inputs (|y| and the
    state reach 10-20 at the model's decays), and each decay
    exp(a_cum[i] - a_cum[j]) carries the rounding of the cumulative sums,
    a few ulps of |a_cum| that each side sums in another order, as a
    relative error into its term. The reference holds its own Pallas scan
    to 2e-3 against its oracle (``tests/test_kernels.py``)."""
    atol, rtol = TOLERANCE[want.dtype]
    wf = want.float()
    if normwise and wf.numel():
        atol *= max(1.0, float(wf.abs().max()))
    err = (got.float() - wf).abs()
    ok = bool((err <= atol + rtol * wf.abs()).all())
    return ok, float(err.max()) if err.numel() else 0.0
