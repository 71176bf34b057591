"""Core layers, as plain functions over parameter dicts of tensors (port
of ``repro/models/layers.py``: RMSNorm and LayerNorm, GQA self-attention,
gated cross-attention, the MLPs, embeddings and sinusoidal positions).

Weight layouts are the reference's einsum layouts: ``wq``/``wk``/``wv``
(d_model, heads, head_dim) and ``wo`` (heads, head_dim, d_model). The
projections view them as 2-D matrices in one place, ``_matmul_heads`` and
``_matmul_out``. Matmul weights are stored in the compute dtype, which is
the rounding the reference applies when it casts its fp32 weights at use;
norm scales and biases stay fp32, as in the reference.

**Tensor parallelism.** Under a serving ruleset with a pool mesh
(``serve.dist.active_pool_mesh``; ``serve.engine.ServingEngine(...,
mesh=...)`` installs it) each rank holds the blocks ``dist.sharding``'s
rules give its weights: q/k/v and gate/up split by columns (heads, mlp),
``wo``/``w_down`` by rows, the embedding and ``lm_head`` by vocab. The
layers then run the collectives XLA inserts for the reference: an
``all_reduce`` after each row-split product, the kv heads gathered
before the pool (which holds every kv head of its pages), the page-table
walk gathered over ranks, and the vocab gathers of the embedding and the
logits. A dim that does not divide the ranks is replicated and needs no
collective.

**Contiguous caches under a serving mesh** (``serve.dist.active_mesh``,
any of (pod, data, model)): each rank holds its slots of the batch, and
the cache's kv heads and rows where its ``spec`` splits them
(``transformer.init_caches(..., ruleset=)``). The heads split as in
training, the row-parallel ``wo`` sum is an ``all_reduce``, and a cache
whose rows are split over an axis (``cache_seq``: sequence parallelism)
is attended rank by rank, each part with its log-sum-exp, and combined
by ``all_reduce``s (``_contiguous_apply``).

**Training over a model axis.** Inside a train step on a mesh
(``train.dist.use_mesh``; its own switch, which the serving paths never
read) the cache-less attention (an encoder's too), the gated
cross-attention, the MLP and the embeddings are split the same way (Megatron's layout, which is what GSPMD makes of the
reference's rules): each column-parallel region takes its input through
``copy`` and each row-parallel product leaves through ``reduce``; the
unembedding leaves the logits vocab-sharded for the loss
(``train.steps.cross_entropy``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.dist import sharding
from repro_torch.kernels import ops as kernel_ops
from repro_torch.serve import dist as serve_dist
from repro_torch.serve import paged
from repro_torch.train import dist as train_dist
from repro_torch.tree import tree_map

Params = Dict[str, object]

NEG_INF = -1e30


# ----------------------------------------------------------------------------
# Norms and rotary embeddings
# ----------------------------------------------------------------------------

def wide(dtype: torch.dtype) -> torch.dtype:
    """The dtype the fp32 islands (norms, the loss, the Mamba scan) run
    in: fp32, or float64 for a float64 input (a gradient check's
    well-conditioned reference). fp32 and bf16 inputs get fp32."""
    return torch.promote_types(dtype, torch.float32)


def rmsnorm(params: Params, x: torch.Tensor, eps: float = 1e-6):
    """RMSNorm in fp32 (``wide``), the scale applied before the cast
    back."""
    dtype = x.dtype
    xf = x.to(wide(dtype))
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * params["scale"]
    return out.to(dtype)


def layernorm(params: Params, x: torch.Tensor, eps: float = 1e-5):
    """LayerNorm in fp32 (``wide``; population variance), scale and bias
    applied before the cast back."""
    dtype = x.dtype
    xf = x.to(wide(dtype))
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, unbiased=False, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps) * params["scale"] \
        + params["bias"]
    return out.to(dtype)


def norm(kind: str, params: Params, x: torch.Tensor):
    """``rmsnorm`` for kind "rms", ``layernorm`` for "layer"."""
    return rmsnorm(params, x) if kind == "rms" else layernorm(params, x)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0):
    """Half-split RoPE. x: (..., seq, heads, head_dim); positions:
    (..., seq). Angles and rotation in fp32, result in x's dtype."""
    d = x.shape[-1]
    half = d // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                          device=x.device) / half))
    angles = positions[..., :, None].float() * freqs        # (..., s, half)
    cos = torch.cos(angles)[..., None, :]                   # (..., s, 1, half)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------------------
# Attention
# ----------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: Optional[float] = 10000.0
    causal: bool = True
    expand_kv: bool = False    # repeat kv heads to q heads in ``sdpa``
    probs_fp32: bool = True    # fp32 scores and probabilities in ``sdpa``


def cast_to(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` in ``dtype`` as the reference's ``astype`` casts it. A float
    tensor cast to an integer dtype (an int8 cache) saturates, as XLA's
    conversion does: NaN becomes 0, values past the type's range its
    bounds, the rest truncated toward zero (torch's own cast wraps, 300
    becoming 44). Any other cast is ``x.to(dtype)``."""
    if dtype.is_floating_point or not x.dtype.is_floating_point:
        return x.to(dtype)
    info = torch.iinfo(dtype)
    x = torch.nan_to_num(x, nan=0.0).clamp(info.min, info.max)
    return x.to(dtype)


def _matmul_heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk"): the (d, h, k) weight as a (d, h*k) matrix."""
    d, h, k = w.shape
    return (x @ w.to(x.dtype).reshape(d, h * k)).unflatten(-1, (h, k))


def _matmul_out(o: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bshk,hkd->bsd"): the (h, k, d) weight as a (h*k, d) matrix."""
    h, k, d = w.shape
    return o.flatten(-2) @ w.to(o.dtype).reshape(h * k, d)


def _project_qkv(params: Params, cfg: AttnConfig, x, positions):
    q = _matmul_heads(x, params["wq"])
    k = _matmul_heads(x, params["wk"])
    v = _matmul_heads(x, params["wv"])
    if cfg.qkv_bias:
        q = q + params["b_q"].to(x.dtype)
        k = k + params["b_k"].to(x.dtype)
        v = v + params["b_v"].to(x.dtype)
    if cfg.qk_norm:
        q = rmsnorm(params["q_norm"], q)
        k = rmsnorm(params["k_norm"], k)
    if cfg.rope_theta:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def sdpa(q, k, v, mask=None, kv_lengths=None, expand_kv: bool = False,
         probs_fp32: bool = True):
    """Scaled dot-product attention with GQA head broadcasting, the
    reference's ``sdpa`` step for step (not the kernels' math).

    q: (b, sq, h, d); k/v: (b, skv, kvh, d); ``mask`` additive, shaped
    (sq, skv) or (b, sq, skv); ``kv_lengths`` (b,) masks a cache: row b's
    keys at or past ``kv_lengths[b]`` score ``NEG_INF`` in the scores'
    dtype (after the mask), as the reference's. ``expand_kv`` repeats
    each kv head to its group of query heads before the scores
    (``repeat_interleave``). The scores are computed in q's dtype and
    cast to fp32 where ``probs_fp32`` (the default), else kept in q's
    dtype; the mask is cast to the scores' dtype; the row maximum is
    taken in the scores' dtype (the reference takes it in fp32 and casts
    it back: the same value, since a maximum is one of its inputs,
    without an fp32 copy of the scores); the exponentials, their sum and
    the division run in the scores' dtype, and the probabilities are cast
    to q's dtype before P.V. With fp32 q the flag changes nothing, bit
    for bit."""
    b, sq, h, d = q.shape
    kvh = k.shape[2]
    group = h // kvh
    if expand_kv and group > 1:
        k = k.repeat_interleave(group, dim=2)
        v = v.repeat_interleave(group, dim=2)
        kvh, group = h, 1
    qg = q.reshape(b, sq, kvh, group, d)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k) / math.sqrt(d)
    scores = scores.to(torch.float32 if probs_fp32 else q.dtype)
    if mask is not None:
        mask = mask.to(scores.dtype)
        scores = scores + (mask[:, None, None] if mask.dim() == 3 else mask)
    if kv_lengths is not None:
        valid = (torch.arange(k.shape[1], device=scores.device)[None, :]
                 < kv_lengths.to(scores.device)[:, None])       # (b, skv)
        scores = torch.where(valid[:, None, None, None, :], scores,
                             torch.tensor(NEG_INF, dtype=scores.dtype,
                                          device=scores.device))
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    probs = (p / p.sum(dim=-1, keepdim=True)).to(q.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
    return out.reshape(b, sq, h, d)


def causal_mask(sq: int, skv: Optional[int] = None, offset: int = 0,
                device=None):
    """Additive causal mask (sq, skv), skv sq by default; query i attends
    keys <= i + offset."""
    qi = torch.arange(sq, device=device)[:, None] + offset
    kj = torch.arange(skv or sq, device=device)[None, :]
    return torch.where(kj <= qi, 0.0, NEG_INF).float()


def attention_apply(params: Params, cfg: AttnConfig, x,
                    cache: Optional[Params] = None, use_flash: bool = False,
                    writes: Optional[tuple] = None
                    ) -> Tuple[torch.Tensor, Optional[Params]]:
    """Self-attention over the whole sequence (no cache; causal unless
    ``cfg.causal`` is False), or s new rows against a cache: a paged one
    (``cache`` holds "kp") or a contiguous one (``cache`` holds "k"/"v").

    Without a cache, ``use_flash`` runs the full-sequence kernel
    (``kernels.ops.flash_attention``, fp32 softmax, no backward), else the
    masked plain ``sdpa`` under ``cfg.expand_kv`` and ``cfg.probs_fp32``.
    With a cache it is not read: cached attention always runs its
    kernels, ``expand_kv`` or not (the reference sends its cached paths
    to the plain ``sdpa`` under ``expand_kv``, a GSPMD hint; the
    kernels' GQA indexing is the same math). The plain ``sdpa`` a
    cached path runs (a contiguous or sharded paged prefill) takes both
    flags. ``writes``: a paged cache's ``paged_writes`` for this step,
    computed here where not given."""
    s = x.shape[1]
    positions = torch.arange(s, device=x.device)[None, :]
    if cache is not None:
        idx = cache["index"].long()
        positions = positions + (idx[:, None] if idx.dim() == 1 else idx)
    if cache is None:
        train = train_dist.sharded("heads", cfg.n_heads)
        if train is not None:
            return _attention_train(params, cfg, x, positions, use_flash,
                                    *train), None
    q, k, v = _project_qkv(params, cfg, x, positions)
    if cache is not None and "k" in cache:
        return _contiguous_apply(params, cfg, x, q, k, v, cache)
    if serve_dist.active_pool_mesh() is not None:
        if cache is None:
            raise NotImplementedError(
                "cache-less attention under a serving mesh: the serving "
                "paths attend a cache (paged or contiguous)")
        return _paged_apply_sharded(params, cfg, x, q, k, v, cache,
                                    writes or paged_writes(cache, s))
    if cache is not None:
        return _paged_apply(params, x, q, k, v, cache,
                            writes or paged_writes(cache, s))
    if use_flash:
        out = kernel_ops.flash_attention(q, k, v, causal=cfg.causal)
    else:
        mask = causal_mask(s, device=x.device) if cfg.causal else None
        out = sdpa(q, k, v, mask=mask, expand_kv=cfg.expand_kv,
                   probs_fp32=cfg.probs_fp32)
    return _matmul_out(out, params["wo"]), None


def _attention_train(params: Params, cfg: AttnConfig, x, positions,
                     use_flash: bool, tm, axis: str, kv_src=None):
    """Cache-less attention under a train step's model axis: column-
    parallel over this rank's q heads (``wq``, ``b_q``) and, where the kv
    heads shard, its kv heads; row-parallel over ``wo``, whose product is
    summed over the axis (``reduce``). Where the kv heads replicate (the
    divisibility fallback) every rank projects them all and keeps those
    its q heads read (``_local_kv_heads``). A weight replicated over the
    axis but used inside the region gets a partial gradient on each
    rank, so it enters through ``copy``: the qk-norm scales (shared by
    every head) and, with the kv heads replicated, ``wk``/``wv``/``b_k``
    /``b_v``. With ``kv_src`` it is the cross-attention's
    (``_cross_qkv``), whose keys and values come from ``kv_src``, which
    enters through ``copy`` too, and which keeps fp32 probabilities and
    the grouped heads whatever ``cfg`` says (the reference's
    ``cross_attention_apply`` passes neither flag to ``sdpa``)."""
    kv_sharded = tm.ruleset.sharded("kv_heads", cfg.n_kv_heads) is not None
    partial = ("q_norm", "k_norm") if kv_sharded else (
        "q_norm", "k_norm", "wk", "wv", "b_k", "b_v")
    p = dict(params)
    for name in partial:
        if name in p:
            p[name] = tree_map(lambda t: tm.copy(t, axis), p[name])
    if kv_src is None:
        q, k, v = _project_qkv(p, cfg, tm.copy(x, axis), positions)
    else:
        q, k, v = _cross_qkv(p, cfg, tm.copy(x, axis),
                             tm.copy(kv_src, axis))
    if not kv_sharded:
        k, v = _local_kv_heads(k, v, cfg.n_heads, q.shape[2],
                               tm.mesh.index(axis))
    if use_flash:
        out = kernel_ops.flash_attention(q, k, v, causal=cfg.causal)
    elif kv_src is not None:
        out = sdpa(q, k, v)
    else:
        mask = causal_mask(x.shape[1], device=x.device) if cfg.causal \
            else None
        out = sdpa(q, k, v, mask=mask, expand_kv=cfg.expand_kv,
                   probs_fp32=cfg.probs_fp32)
    return tm.reduce(_matmul_out(out, params["wo"]), axis)


def _write_rows(ck, cv, k, v, local):
    """Write the (b, s) new rows of k/v at this rank's cache rows
    ``local`` (b, s), in place, dropping those outside [0, L) (past the
    cache's end, or in another rank's block of it), with no host read:
    each row is written at ``local mod L`` with its new value where it is
    kept and the value already there where it is dropped. Within a piece
    of at most L consecutive rows those targets are distinct, so no two
    writes meet; pieces run in order, each reading what the last left.
    The rows are cast to the cache's dtype by ``cast_to`` (an int8 cache
    saturates, as the reference's does)."""
    b, s = local.shape
    rows = ck.shape[1]
    slots = torch.arange(b, device=k.device)[:, None].expand(b, s)
    for a in range(0, s, rows):
        p, sl = local[:, a:a + rows], slots[:, a:a + rows]
        kept = ((p >= 0) & (p < rows))[..., None, None]
        t = p.remainder(rows)
        ck[sl, t] = torch.where(kept, cast_to(k[:, a:a + rows], ck.dtype),
                                ck[sl, t])
        cv[sl, t] = torch.where(kept, cast_to(v[:, a:a + rows], cv.dtype),
                                cv[sl, t])


def _partial_attention(q, k, v, mask, probs_fp32: bool = True):
    """The plain masked attention of q (b, sq, h, d) over k/v (b, skv,
    kvh, d), and each row's fp32 log-sum-exp of its scaled scores
    (b, sq, h): one rank's part of attention over a cache whose rows the
    ranks share out (``_combine_seq``). It runs in fp32, or in q's dtype
    where ``probs_fp32`` is False. A row with no key left by the mask has
    a log-sum-exp near
    ``NEG_INF``, which weighs nothing. (The reference splits rows
    through GSPMD and has no such function.)"""
    b, sq, h, d = q.shape
    kvh = k.shape[2]
    sd = torch.float32 if probs_fp32 else q.dtype
    qg = q.to(sd).reshape(b, sq, kvh, h // kvh, d)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.to(sd)) / math.sqrt(d)
    scores = scores + mask.to(sd)[:, None, None]
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p / l, v.to(sd))
    lse = (m.float() + torch.log(l.float()))[..., 0].permute(0, 3, 1, 2)
    return out.reshape(b, sq, h, d), lse.reshape(b, sq, h)


def _combine_seq(out, lse, mesh, axes):
    """Attention over the whole cache from each rank's part over its
    rows: out (..., h, d) and lse (..., h) fp32, combined over ``axes``
    by an ``all_reduce(MAX)`` of lse, then an ``all_reduce(SUM)`` of
    ``exp(lse - m) * out`` and of ``exp(lse - m)``. A rank with no row
    (lse -inf) weighs nothing."""
    m = lse.clone()
    for a in axes:
        serve_dist.all_reduce(m, mesh, a, op=torch.distributed.ReduceOp.MAX)
    w = torch.exp(lse - torch.where(torch.isinf(m), torch.zeros_like(m), m))
    num = out.float() * w[..., None]
    for a in axes:
        serve_dist.all_reduce(num, mesh, a)
        serve_dist.all_reduce(w, mesh, a)
    w = torch.where(w > 0, w, torch.ones_like(w))
    return (num / w[..., None]).to(out.dtype)


def _contiguous_apply(params: Params, cfg: AttnConfig, x, q, k, v,
                      cache: Params):
    """Attention against a contiguous KV cache, on one rank or sharded by
    the serving mesh (``serve.dist.active_mesh``).

    cache = {"k"/"v": (b, max_len, kvh, hd) in the cache's dtype (the
    compute dtype, or int8: written through ``cast_to``, read back cast to
    q's dtype before any kernel or ``sdpa``), "index":
    (b,) per-slot write positions, or a scalar one shared by every slot,
    and under a mesh the k/v ``spec``}. The s new K/V rows are written at
    ``index`` first, **in place** (the reference returns a new cache);
    rows past ``max_len`` are dropped, as the reference's scatter drops
    them (``_write_rows``, no host sync). The returned cache carries the
    advanced ``index``. At s == 1 (decode) attention is the contiguous
    decode kernel (``kernels.ops.flash_decode``) over each slot's first
    ``index + 1`` rows; at s > 1 (prefill) it is the reference's plain
    causal ``sdpa`` over the whole cache, query r of slot i seeing rows
    ``<= index[i] + r``, under ``cfg.expand_kv`` and ``cfg.probs_fp32``.

    Under a mesh this rank holds its slots of the batch, and its kv heads
    and block of rows where the cache's ``spec``
    (``transformer.init_caches(..., ruleset=)``: (batch, cache_seq,
    kv_heads, None)) splits them. q/k/v hold this rank's heads where the
    heads rules split the weights (as ``_attention_train`` splits them in
    training); k/v are gathered over kv heads where the weights split
    them and the cache does not. The new rows go to the rank whose block
    holds their positions. Where the rows are split (``cache_seq`` mapped
    to an axis: sequence parallelism), each rank's attention is partial,
    with its log-sum-exp (``return_lse``, ``_partial_attention``), and
    the ranks combine it (``_combine_seq``); where the heads split over
    that same axis, q is gathered over heads first and each rank keeps
    its heads of the combined rows. A head-split output projection is
    summed over ranks."""
    mesh = serve_dist.active_mesh()
    spec = cache.get("spec", (None,) * 4)
    b, s = x.shape[:2]
    ck, cv = cache["k"], cache["v"]
    rows = ck.shape[1]
    kv_w = serve_dist.sharded("kv_heads", cfg.n_kv_heads)
    if kv_w is not None and spec[2] is None:
        k = serve_dist.all_gather_dim(k, 2, *kv_w)
        v = serve_dist.all_gather_dim(v, 2, *kv_w)
    elif kv_w is None and spec[2] is not None:
        raise ValueError(f"the cache splits kv heads over {spec[2]}, the "
                         f"weights do not")
    seq_axes, row0 = (), 0
    if spec[1] is not None:
        seq_axes, _, i = sharding._block(spec[1], mesh)
        row0 = i * rows
    idx = cache["index"].long().expand(b)
    pos = idx[:, None] + torch.arange(s, device=x.device)[None, :]
    _write_rows(ck, cv, k, v, pos - row0)
    new_cache = dict(cache, index=cache["index"] + s)
    heads = serve_dist.sharded("heads", cfg.n_heads)
    kh, vh = ck, cv
    # Rows and heads split over one axis (``cache_seq`` on "model"): the
    # ranks that combine a row's partials must hold the same heads, so
    # each attends every head over its rows and keeps its own after.
    every_head = heads is not None and heads[1] in seq_axes
    q_local = q.shape[2]
    if every_head:
        q = serve_dist.all_gather_dim(q, 2, *heads)
    elif heads is not None and spec[2] is None:
        kh, vh = _local_kv_heads(ck, cv, cfg.n_heads, q_local,
                                 heads[0].index(heads[1]))
    kh, vh = kh.to(q.dtype), vh.to(q.dtype)
    if s == 1:
        lens = (idx + 1 - row0).clamp(0, rows).int()
        if seq_axes:
            out, lse = kernel_ops.flash_decode(q[:, 0], kh, vh, lens,
                                               return_lse=True)
            out = _combine_seq(out, lse, mesh, seq_axes)
        else:
            out = kernel_ops.flash_decode(q[:, 0], kh, vh, lens)
        out = out[:, None]
    else:
        kj = row0 + torch.arange(rows, device=x.device)[None, None, :]
        mask = torch.where(kj <= pos[:, :, None], 0.0, NEG_INF).float()
        if seq_axes:
            out, lse = _partial_attention(q, kh, vh, mask, cfg.probs_fp32)
            out = _combine_seq(out, lse, mesh, seq_axes).to(q.dtype)
        else:
            out = sdpa(q, kh, vh, mask=mask, expand_kv=cfg.expand_kv,
                       probs_fp32=cfg.probs_fp32)
    if every_head:
        out = out.narrow(2, heads[0].index(heads[1]) * q_local, q_local)
    y = _matmul_out(out, params["wo"])
    if heads is not None:
        serve_dist.all_reduce(y, *heads)      # wo split by rows
    return y, new_cache


def paged_writes(cache: Params, s: int) -> tuple:
    """Where a step's s new K/V rows a slot land in a paged pool (one
    table serves every layer, so a forward computes this once): (pos,
    page, row) (b, s), each row's position, global page id (0, the null
    page, past the table's reach) and in-page row, and src (b * s,) the
    write whose values each one carries (``serve.paged.last_writers``,
    over the whole pool's rows where the ranks shard it)."""
    idx = cache["index"].long()                        # (b,)
    kp, pages = cache["kp"], cache["pages"]
    page_size, max_pages = kp.shape[1], pages.shape[1]
    pos = idx[:, None] + torch.arange(s, device=kp.device)[None, :]
    pj = pos.div(page_size, rounding_mode="floor").clamp(0, max_pages - 1)
    page = torch.gather(pages.long(), 1, pj)
    page = torch.where(pos < max_pages * page_size, page,
                       torch.zeros_like(page))
    row = pos % page_size
    pool_rows = kp.shape[0] * page_size
    sharded = serve_dist.active_pool_mesh()
    if sharded is not None:
        pool_rows *= int(sharded[0].shape[sharded[1]])
    return pos, page, row, paged.last_writers(page, row, page_size,
                                              pool_rows)


def _paged_apply(params: Params, x, q, k, v, cache: Params, writes: tuple):
    """Attention against a paged KV cache: single-token decode (s == 1)
    and in-place chunked prefill (s > 1) share one path.

    cache = {"kp"/"vp": (n_pages, page_size, kvh, hd) pool, "pages":
    (b, max_pages) page table (0 = null page), "index": (b,) per-slot
    write position}. The s new K/V rows are written through the table
    first (write-then-attend). A position past the table's reach lands in
    the null page, as does every write of a slot whose table row is zero.
    The pool is updated in place (the reference returns a new pool); the
    returned cache carries the advanced ``index``. Attention itself is
    one of the two kernels (``kernels.ops``), whose wrappers send CPU
    tensors to their plain versions."""
    s = x.shape[1]
    kp, vp, pages = cache["kp"], cache["vp"], cache["pages"]
    _, page, row, src = writes
    paged.write_rows(kp, vp, k, v, page, row, src)
    new_cache = dict(cache, index=cache["index"] + s)
    if s == 1:
        out = kernel_ops.flash_decode_paged(
            q[:, 0], kp, vp, pages, cache["index"] + 1)[:, None]
    else:
        # The chunk's rows are already in the pool: queries at idx + r
        # attend every written row <= their position.
        out = kernel_ops.flash_attention_paged(q, kp, vp, pages,
                                               cache["index"])
    return _matmul_out(out, params["wo"]), new_cache


def _local_kv_heads(ck, cv, n_heads: int, q_local: int, rank: int):
    """The kv heads this rank's q heads read from the full (b, L, kvh, d)
    views (or a train step's (b, s, kvh, d) projections): q heads [rank * q_local, (rank + 1) * q_local) read kv heads
    j // group, a contiguous slice when the rank's heads cover whole
    groups or lie inside one (every registry config at 2, 4 and 8
    ranks)."""
    kvh = ck.shape[2]
    group = n_heads // kvh
    if q_local % group and group % q_local:
        raise ValueError(f"{q_local} q heads a rank split the groups of "
                         f"{group} q heads a kv head")
    lo = rank * q_local // group
    hi = ((rank + 1) * q_local - 1) // group + 1
    return ck[:, :, lo:hi].contiguous(), cv[:, :, lo:hi].contiguous()


def _paged_apply_sharded(params: Params, cfg: AttnConfig, x, q, k, v,
                         cache: Params, writes: tuple):
    """Paged attention against a pool sharded over ranks by pages
    (``serve.dist``), the port of the reference's
    ``_paged_apply_sharded``. q/k/v hold this rank's heads where the
    heads rule shards them; the pool holds every kv head of its pages,
    so k/v are gathered over kv heads first (the move XLA makes between
    the reference's head-sharded ``wk``/``wv`` and its pool). The rows
    are scattered into the owning rank's pages, and the page-table walk
    gathers the contiguous view on every rank; at s == 1 the contiguous
    decode kernel (``kernels.ops.flash_decode``) attends it, at s > 1
    the masked plain ``sdpa`` under ``cfg.expand_kv`` and
    ``cfg.probs_fp32`` (as the reference). A head-sharded output
    projection is summed over ranks."""
    mesh, axis = serve_dist.active_pool_mesh()
    s = x.shape[1]
    kp, vp, pages = cache["kp"], cache["vp"], cache["pages"]
    pos, page, row, src = writes
    kv_heads = serve_dist.sharded("kv_heads", cfg.n_kv_heads)
    if kv_heads is not None:
        k = serve_dist.all_gather_dim(k, 2, *kv_heads)
        v = serve_dist.all_gather_dim(v, 2, *kv_heads)
    serve_dist.scatter_pages(kp, vp, k, v, page, row, mesh, axis, src)
    new_cache = dict(cache, index=cache["index"] + s)
    ck, cv = serve_dist.gather_pages(kp, vp, pages, mesh, axis)
    heads = serve_dist.sharded("heads", cfg.n_heads)
    if heads is not None:
        ck, cv = _local_kv_heads(ck, cv, cfg.n_heads, q.shape[2],
                                 heads[0].index(heads[1]))
    ck, cv = ck.to(q.dtype), cv.to(q.dtype)
    if s == 1:
        out = kernel_ops.flash_decode(q[:, 0], ck, cv,
                                      (cache["index"] + 1).int())[:, None]
    else:
        kj = torch.arange(ck.shape[1], device=x.device)[None, None, :]
        mask = torch.where(kj <= pos[:, :, None], 0.0, NEG_INF).float()
        out = sdpa(q, ck, cv, mask=mask, expand_kv=cfg.expand_kv,
                   probs_fp32=cfg.probs_fp32)
    y = _matmul_out(out, params["wo"])
    if heads is not None:
        serve_dist.all_reduce(y, *heads)      # wo split by rows
    return y, new_cache


def _cross_qkv(params: Params, cfg: AttnConfig, x, kv_src):
    q = _matmul_heads(x, params["wq"])
    k = _matmul_heads(kv_src, params["wk"])
    v = _matmul_heads(kv_src, params["wv"])
    if cfg.qk_norm:
        q = rmsnorm(params["q_norm"], q)
        k = rmsnorm(params["k_norm"], k)
    return q, k, v


def cross_attention_apply(params: Params, cfg: AttnConfig, x, kv_src):
    """Cross-attention: queries from x (b, s, d), keys and values from
    ``kv_src`` (b, n, d) in x's dtype; unmasked plain ``sdpa``, no biases
    and no RoPE (as the reference), the output scaled by ``tanh(gate)``
    where the layer has a gate (llama-3.2-vision). It keeps fp32
    probabilities and grouped kv heads whatever ``cfg.probs_fp32`` and
    ``cfg.expand_kv`` say, as the reference's, which passes neither to
    ``sdpa``. Under a train step's model axis, or a serving mesh's (``serve.dist.split``; ``kv_src``
    then holds this rank's slots, as the tokens do), it is split by heads
    as the self-attention is (``_attention_train``), and the gate scales
    the summed output, so that its gradient is whole on every rank."""
    split = train_dist.sharded("heads", cfg.n_heads) \
        or serve_dist.split("heads", cfg.n_heads)
    if split is not None:
        y = _attention_train(params, cfg, x, None, False, *split,
                             kv_src=kv_src)
    else:
        q, k, v = _cross_qkv(params, cfg, x, kv_src)
        y = _matmul_out(sdpa(q, k, v), params["wo"])
    if "gate" in params:
        y = torch.tanh(params["gate"]).to(x.dtype) * y
    return y


# ----------------------------------------------------------------------------
# MLP, embeddings
# ----------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MLPConfig:
    d_model: int
    d_ff: int
    activation: str = "swiglu"        # "swiglu" | "gelu"


def _mlp(params: Params, cfg: MLPConfig, x):
    if cfg.activation == "swiglu":
        g = x @ params["w_gate"].to(x.dtype)
        u = x @ params["w_up"].to(x.dtype)
        h = F.silu(g) * u
    else:
        # jax.nn.gelu defaults to the tanh approximation.
        h = F.gelu(x @ params["w_up"].to(x.dtype)
                   + params["b_up"].to(x.dtype), approximate="tanh")
    return h @ params["w_down"].to(x.dtype)


def mlp_apply(params: Params, cfg: MLPConfig, x):
    """The MLP; split by ``mlp`` columns (gate/up, ``b_up``) and
    ``w_down`` rows under a serving pool mesh or a train step's model
    axis, its output summed over the ranks."""
    train = train_dist.sharded("mlp", cfg.d_ff)
    if train is not None:
        tm, axis = train
        return tm.reduce(_mlp(params, cfg, tm.copy(x, axis)), axis)
    y = _mlp(params, cfg, x)
    tp = serve_dist.sharded("mlp", cfg.d_ff)
    if tp is not None:
        serve_dist.all_reduce(y, *tp)        # w_down split by rows
    return y


def _vocab_rows(table, tokens, first: int, dtype):
    """The rows of ``tokens`` that a vocab-sharded ``table`` holds (its
    first global row ``first``), zeros for the rest."""
    local = tokens.long() - first
    owned = (local >= 0) & (local < table.shape[0])
    out = table[torch.where(owned, local, torch.zeros_like(local))]
    return torch.where(owned[..., None], out,
                       torch.zeros((), dtype=dtype, device=out.device))


def embed(params: Params, tokens, dtype=torch.float32,
          vocab: Optional[int] = None):
    """The embedding rows of ``tokens``. Under a pool mesh or a train
    step's model axis whose vocab rule shards the table (``vocab`` its
    global rows), each rank looks up the tokens in its rows, zeros for
    the rest, and one ``all_reduce`` assembles them (exact: one rank owns
    each token)."""
    table = params["embedding"].to(dtype)
    if vocab is not None:
        train = train_dist.sharded("vocab", vocab)
        if train is not None:
            tm, axis = train
            out = _vocab_rows(table, tokens,
                              tm.mesh.index(axis) * table.shape[0], dtype)
            return tm.reduce(out, axis)
    tp = None if vocab is None else serve_dist.sharded("vocab", vocab)
    if tp is None:
        return table[tokens.long()]
    mesh, axis = tp
    out = _vocab_rows(table, tokens, mesh.index(axis) * table.shape[0],
                      dtype)
    return serve_dist.all_reduce(out, mesh, axis)


def unembed(params: Params, x, vocab: Optional[int] = None):
    """The logits ``x @ lm_head``; under a pool mesh whose vocab rule
    shards ``lm_head`` (``vocab`` its global columns), through
    ``dist.collective_matmul.serve_unembed``; under a train step's model
    axis, this rank's vocab columns of the logits (the loss is sharded
    the same way)."""
    if vocab is not None:
        train = train_dist.sharded("vocab", vocab)
        if train is not None:
            tm, axis = train
            return tm.copy(x, axis) @ params["lm_head"].to(x.dtype)
    tp = None if vocab is None else serve_dist.sharded("vocab", vocab)
    if tp is not None:
        from repro_torch.dist import collective_matmul
        return collective_matmul.serve_unembed(*tp)(params, x)
    return x @ params["lm_head"].to(x.dtype)


def sinusoidal_positions(n: int, d: int, device=None) -> torch.Tensor:
    """(n, d) fp32 absolute positions, sines then cosines, built in numpy
    float64 and rounded once (the encoder's table, as the reference)."""
    pos = np.arange(n)[:, None]
    dim = np.arange(d // 2)[None, :]
    angle = pos / np.power(10000.0, 2 * dim / d)
    out = np.concatenate([np.sin(angle), np.cos(angle)], axis=-1)
    return torch.from_numpy(out).to(device=device, dtype=torch.float32)
