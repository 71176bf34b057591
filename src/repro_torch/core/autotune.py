"""Microbenchmark-informed tuning on the H100 (the paper's Ch.1 thesis), and
the serving path's cost models and their calibrated constants.

The paper's demonstration is that measured microarchitectural parameters
let a human beat the compiler's schedule. Here the card's published limits
(``hwmodel.H100``) and constants measured on it (``core.calibrate``) drive
analytical choices. Port of ``repro/core/autotune.py``, priced for the
port's own kernels.

GEMM tiles
----------

The GEMM kernels (``kernels/csrc/gemm.cu``, ``kernels.gemm.TILES``)
instantiate a few tiles for each input type; the chooser picks among them:

* a candidate is an instantiated tile of the input type whose staged input
  tiles fit one block's shared memory (the reference's VMEM budget): two
  fp32 buffers for the CUDA-core kernel, ``TC_STAGES`` bf16 ones for the
  tensor-core kernel;
* the reference's MXU efficiency becomes the tile efficiency: the useful
  share of the padded (m, k, n) that the tiles cover, times the wave
  quantisation of waves of ``resident_ctas`` tiles on each of the 132 SMs
  (the CTAs an SM holds by its registers, shared memory and thread
  slots), times the share of the SM's dispatch slots the resident warps
  keep busy (``dispatch_share``), at the engine's rate: the CUDA cores'
  fp32 FFMA rate for fp32 inputs, the tensor cores' dense bf16 rate for
  bf16;
* the traffic formula is the reference's C-stationary one, unchanged: with
  (bm, bk, bn) tiles A is streamed n/bn times, B m/bm times and C once.

Attention kernels
-----------------

The attention wrappers (``kernels.ops``) take the reference's
``block_q``/``block_k``; None asks ``choose_attn_block``, which keeps the
reference's names and contract (the tuning cache below, keyed by card,
devices and problem) with the port's own tiles and prices:

* a candidate is a tile the build instantiates for the kernel the problem
  runs (``AttnProblem.kernel``) whose staged tiles fit one block's shared
  memory: the prefill bodies' query blocks ``BLOCK_QS`` (16 or 64 rows, a
  template of ``csrc/paged_attention.cu``) by the 64-row key tile; the
  split decode's one query block by its split lengths
  (``SPLIT_ROWS_SET``, taken at launch, in whole pages);
* the reference's MXU efficiency (``mxu_efficiency``) becomes the used
  share of the padded query block times the fill of the card
  (``attn_fill``: the launch's CTAs in waves of ``attn_resident_ctas`` on
  the 132 SMs, an SM's share its warps over its schedulers), at the
  engine's rate, as ``tile_efficiency`` prices the GEMM; and a launch
  lasts at least its longest CTA a wave (``cta_share``);
* the traffic is the reference's (K/V once a visited step of each row),
  plus, for a decode, the splits' fp32 partials, written and read back by
  the merge: the term that keeps the shortest split from always winning.

The serving models (``decode_launch``, ``prefill_launch`` and the models
over them) price the tile ``choose_attn_block(..., use_cache=False)``
picks, as the reference's do.

Serving-path cost constants
---------------------------

The serving models price fixed costs with the constants below. Each has a
hand-set default, an assumption written down before anything was measured
(the reproducible fallback), and a value measured on the device by
``core.calibrate`` (``python -m repro_torch.launch.calibrate``), kept in
the port's tuning cache under the ``calibrated:`` namespace and preferred by
``resolve_constants``:

===================  =========  ==========================================
constant             default    measured by (``core.calibrate`` probe)
===================  =========  ==========================================
``PAGE_LOOKUP_S``    5e-10 s    the paged decode's slope against the
                                contiguous decode's over a sweep of
                                context lengths, per page-table entry read
``CHUNK_DISPATCH_S`` 2e-5 s     the mean chunk span of a small paged
                                engine (on the card: a graph replay's
                                launch)
``PREFIX_HASH_S``    2e-6 s     a timed digest chain, per page of tokens
``NGRAM_DRAFT_S``    2e-6 s     a timed ``NgramDraft.propose``, per token
``dispatch_s``       (none)     best-of-N round trip of a tiny kernel (no
                                model term: its baseline is
                                ``CHUNK_DISPATCH_S``)
``hbm_bandwidth``    the spec   a timed ``a + 1`` stream several times the
                                size of the L2 (read and write)
===================  =========  ==========================================

Every model and ``choose_*`` takes ``constants=`` (a ``ServeConstants``);
None means the hand-set defaults. The serving engine resolves them once,
at construction (``resolve_constants``); ``REPRO_DEFAULT_CONSTANTS=1``
forces the defaults.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import tempfile
from typing import Iterable, List, Optional, Tuple

import torch

from repro_torch.core import hwmodel
from repro_torch.kernels import flash_attention as _prefill_kernel
from repro_torch.kernels import flash_decode as _decode_kernel
from repro_torch.kernels.gemm import REGISTERS, TC_STAGES, TC_THREADS, TILES

DTYPE_OF = {4: torch.float32, 2: torch.bfloat16}     # by input bytes


@dataclasses.dataclass(frozen=True)
class GemmProblem:
    m: int
    k: int
    n: int
    in_bytes: int = 2          # bf16
    acc_bytes: int = 4         # fp32 accumulator


@dataclasses.dataclass(frozen=True)
class GemmConfig:
    bm: int
    bk: int
    bn: int

    def smem_bytes(self, in_bytes: int = 4) -> int:
        """Staged input tiles in shared memory; the accumulator lives in
        registers. fp32: two buffers, as fp32. bf16: the tensor-core
        kernel's ring of ``TC_STAGES`` bf16 stages."""
        if in_bytes == 2:
            return TC_STAGES * (self.bm + self.bn) * self.bk * 2
        return 2 * (self.bm * self.bk + self.bk * self.bn) * 4


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def cta_threads(c: GemmConfig, in_bytes: int) -> int:
    """Threads of one CTA of the tile's kernel: the tensor-core kernel's
    two consumer warpgroups and producer warp, or one thread for each 8 x 8
    register tile of the CUDA-core kernel."""
    return TC_THREADS if in_bytes == 2 else (c.bm // 8) * (c.bn // 8)


def resident_ctas(c: GemmConfig, in_bytes: int,
                  gpu: hwmodel.GPUSpec = hwmodel.H100) -> int:
    """CTAs of the tile's kernel that one SM holds at once: the least that
    its registers (allocated a warp at a time, 256 at a time; the counts
    ptxas reports, ``kernels.gemm.REGISTERS``), its shared memory (with the
    block's reserved kilobyte), its thread slots and its block slots
    allow. A tile the build does not instantiate has no register count:
    its registers are not priced."""
    threads = cta_threads(c, in_bytes)
    warps = _ceil_div(threads, 32)
    fits = [gpu.smem_per_sm // (c.smem_bytes(in_bytes)
                                + gpu.smem_per_cta_reserved),
            gpu.max_threads_per_sm // threads, gpu.max_ctas_per_sm]
    regs = REGISTERS[DTYPE_OF[in_bytes]].get(dataclasses.astuple(c))
    if regs is not None:
        per_warp = _ceil_div(regs * 32, 256) * 256
        fits.append(gpu.regs_per_sm // per_warp // warps)
    return max(1, min(fits))


def dispatch_share(c: GemmConfig, in_bytes: int,
                   gpu: hwmodel.GPUSpec = hwmodel.H100) -> float:
    """Share of an SM's dispatch slots the resident warps keep busy. The
    CUDA-core kernel's dependent FFMA waits 4 cycles (Table 4.1's FFMA:
    ``hwmodel.VOLTA_INSTR_LATENCY``, 4 cycles on Hopper too), so each of
    the SM's schedulers needs that many resident warps to dispatch every
    cycle. The tensor-core kernel's ``wgmma`` runs asynchronously beside
    its warps: 1."""
    if in_bytes == 2:
        return 1.0
    warps = resident_ctas(c, in_bytes, gpu) * _ceil_div(
        cta_threads(c, in_bytes), 32)
    need = gpu.schedulers_per_sm * hwmodel.VOLTA_INSTR_LATENCY["FFMA"]
    return min(1.0, warps / need)


def tile_efficiency(p: GemmProblem, c: GemmConfig,
                    gpu: hwmodel.GPUSpec = hwmodel.H100) -> float:
    """Useful share of the engine's peak a tiling buys: the problem over
    its padding to whole tiles in m, k and n, times the filled share of the
    last wave (a wave: ``resident_ctas`` tiles on every SM), times the
    resident warps' share of the dispatch slots (``dispatch_share``)."""
    pm, pk, pn = (_ceil_div(d, b) * b for d, b in ((p.m, c.bm), (p.k, c.bk),
                                                   (p.n, c.bn)))
    tiles = _ceil_div(p.m, c.bm) * _ceil_div(p.n, c.bn)
    per_wave = gpu.sms * resident_ctas(c, p.in_bytes, gpu)
    waves = _ceil_div(tiles, per_wave)
    return ((p.m * p.k * p.n) / (pm * pk * pn) * tiles / (waves * per_wave)
            * dispatch_share(c, p.in_bytes, gpu))


def gemm_cost(p: GemmProblem, c: GemmConfig,
              gpu: hwmodel.GPUSpec = hwmodel.H100) -> Tuple[float, dict]:
    """Modeled execution time (seconds) of the GEMM, plus terms. The
    compute term runs at the engine's peak for the input type."""
    flops = 2.0 * p.m * p.k * p.n
    eff = tile_efficiency(p, c, gpu)
    compute_s = flops / (peak_flops(p.in_bytes, gpu) * eff)
    # Device-memory traffic in bytes (C-stationary): A x (N/bn), B x (M/bm),
    # C once.
    a_reads = _ceil_div(p.n, c.bn)
    b_reads = _ceil_div(p.m, c.bm)
    traffic = (p.m * p.k * a_reads + p.k * p.n * b_reads) * p.in_bytes \
        + p.m * p.n * p.in_bytes
    memory_s = traffic / gpu.hbm_bandwidth
    t = max(compute_s, memory_s)
    return t, {"compute_s": compute_s, "memory_s": memory_s,
               "traffic_bytes": traffic, "tile_efficiency": eff}


def peak_flops(in_bytes: int, gpu: hwmodel.GPUSpec = hwmodel.H100) -> float:
    """The engine's rate for the input type: tensor cores for bf16, CUDA
    cores for fp32 (the kernel keeps fp32 off the TF32 tensor cores)."""
    return gpu.peak_bf16_flops if in_bytes == 2 else gpu.peak_fp32_flops


def tiles(in_bytes: int) -> tuple:
    """The (bm, bk, bn) tiles the kernel instantiates for the input type."""
    return TILES[DTYPE_OF[in_bytes]]


def candidate_blocks(in_bytes: int = 4,
                     gpu: hwmodel.GPUSpec = hwmodel.H100) -> List[GemmConfig]:
    """The input type's instantiated tiles that fit one block's shared
    memory."""
    return [c for c in (GemmConfig(*t) for t in tiles(in_bytes))
            if c.smem_bytes(in_bytes) <= gpu.smem_per_block]


def choose_gemm_block(p: GemmProblem,
                      gpu: hwmodel.GPUSpec = hwmodel.H100
                      ) -> Tuple[GemmConfig, dict]:
    """Pick the minimum-modeled-time tile (the autotuner's decision)."""
    best, best_t, best_terms = None, float("inf"), None
    for c in candidate_blocks(p.in_bytes, gpu):
        t, terms = gemm_cost(p, c, gpu)
        if t < best_t:
            best, best_t, best_terms = c, t, terms
    return best, dict(best_terms, time_s=best_t)


def naive_block(in_bytes: int) -> GemmConfig:
    """The smallest tile of the input type: the baseline a tuned tile is
    measured against."""
    return GemmConfig(*min(tiles(in_bytes)))


# The reference's baseline for its default input, bf16 (``naive_block``
# gives each input type's).
NAIVE_BLOCK = naive_block(2)


def tuning_gain(p: GemmProblem,
                gpu: hwmodel.GPUSpec = hwmodel.H100) -> dict:
    """Naive-vs-tuned comparison — the Ch.1 '+15.4%' analogue, reported by
    ``launch/autotune_gemm.py`` beside the kernel's measured times."""
    naive = naive_block(p.in_bytes)
    t_naive, naive_terms = gemm_cost(p, naive, gpu)
    cfg, terms = choose_gemm_block(p, gpu)
    return {
        "naive": {"config": dataclasses.astuple(naive), **naive_terms,
                  "time_s": t_naive},
        "tuned": {"config": dataclasses.astuple(cfg), **terms},
        "speedup": t_naive / terms["time_s"],
    }


# ----------------------------------------------------------------------------
# Attention kernels: the tiles the port's kernels instantiate, priced on the
# H100.
# ----------------------------------------------------------------------------

PREFILL = "prefill"   # prefill_kernel / prefill_mma_kernel
DECODE = "decode"     # decode_split_kernel


@dataclasses.dataclass(frozen=True)
class AttnProblem:
    """One flash-attention launch: ``batch * n_heads`` independent rows of a
    (sq x skv x head_dim) attention, causally masked or not.

    For flash *decode* set ``sq`` to the GQA group size (queries per KV head)
    and ``n_heads`` to ``n_kv_heads`` — that is exactly the row shape the
    decode kernel runs per (slot, kv head) grid step.

    ``kernel`` names the body that runs the launch (``PREFILL`` or
    ``DECODE``): the two have different tiles. ``page_size`` is the pool's
    page for a paged decode, whose splits are whole pages (1: a contiguous
    cache)."""

    sq: int
    skv: int
    n_heads: int
    head_dim: int
    batch: int = 1
    causal: bool = True
    in_bytes: int = 2          # bf16
    kernel: str = PREFILL
    page_size: int = 1


@dataclasses.dataclass(frozen=True)
class AttnBlock:
    """A kernel's tile. Prefill: ``block_q`` query rows a CTA (one of
    ``kernels.flash_attention.BLOCK_QS``) and ``block_k`` key rows a step
    (``TILE_K``). Decode: ``block_q`` the query block of a CTA
    (``kernels.flash_decode.QUERY_BLOCK``) and ``block_k`` the rows of a
    split (one of ``SPLIT_ROWS_SET``, rounded to whole pages at launch)."""

    block_q: int
    block_k: int


def _attn_visited_blocks(p: AttnProblem, c: AttnBlock) -> int:
    """Number of (q-block, k-block) grid steps the skipped-load causal grid
    actually visits — the quantity the scalar-prefetch map shrinks."""
    nq = _ceil_div(p.sq, c.block_q)
    nk = _ceil_div(p.skv, c.block_k)
    if not p.causal:
        return nq * nk
    off = p.skv - p.sq          # query i attends keys <= i + off
    total = 0
    for qi in range(nq):
        last_row = min(qi * c.block_q + c.block_q - 1, p.sq - 1)
        total += min(_ceil_div(last_row + off + 1, c.block_k), nk)
    return total


def attn_threads(p: AttnProblem, c: AttnBlock) -> int:
    """Threads of one CTA: the decode's 4 warps, the bf16 prefill's warp
    for every 16 query rows, the fp32 prefill's 256."""
    if p.kernel == DECODE:
        return _decode_kernel.THREADS
    return 2 * c.block_q if p.in_bytes == 2 else 256


def attn_smem_bytes(p: AttnProblem, c: AttnBlock) -> int:
    """Dynamic shared memory of one CTA, as ``csrc/paged_attention.cu``
    sizes it. bf16 prefill: the Q tile and K/V tiles double-buffered, rows
    padded to d + 8; fp32 prefill: Q, K, V (rows padded to d + 1) and the
    P tile; decode: each warp's ring of 16-row K/V stages (3 in bf16, 2 in
    fp32, rows padded by 16 bytes), the query block, and on a paged pool
    the page-table entries of a split."""
    d = p.head_dim
    if p.kernel == DECODE:
        stages = 3 if p.in_bytes == 2 else 2
        ring = stages * 2 * _decode_kernel.WARP_ROWS * (d * p.in_bytes + 16)
        q = c.block_q * (d + 8) * 2 if p.in_bytes == 2 else c.block_q * d * 4
        entries = 4 * (_decode_kernel.split_rows(c.block_k, p.page_size)
                       // p.page_size + 2) if p.page_size > 1 else 0
        return _decode_kernel.THREADS // 32 * ring + q + entries
    tk = _prefill_kernel.TILE_K
    if p.in_bytes == 2:
        return (c.block_q + 4 * tk) * (d + 8) * 2
    return 4 * ((c.block_q + 2 * tk) * (d + 1) + c.block_q * (tk + 1))


def attn_resident_ctas(p: AttnProblem, c: AttnBlock,
                       gpu: hwmodel.GPUSpec = hwmodel.H100) -> int:
    """CTAs of the tile's kernel one SM holds at once, by its shared
    memory (with the block's reserved kilobyte), thread slots and block
    slots. Registers are not priced: the attention bodies' counts are not
    recorded beside the Python (the GEMM's are, ``resident_ctas``)."""
    return max(1, min(gpu.smem_per_sm // (attn_smem_bytes(p, c)
                                          + gpu.smem_per_cta_reserved),
                      gpu.max_threads_per_sm // attn_threads(p, c),
                      gpu.max_ctas_per_sm))


def attn_waves(p: AttnProblem, c: AttnBlock, ctas: int,
               gpu: hwmodel.GPUSpec = hwmodel.H100) -> int:
    """Waves of a launch of ``ctas`` CTAs: ``attn_resident_ctas`` on each
    of the 132 SMs at a time."""
    return max(1, _ceil_div(ctas, gpu.sms * attn_resident_ctas(p, c, gpu)))


def cta_share(p: AttnProblem, c: AttnBlock,
              gpu: hwmodel.GPUSpec = hwmodel.H100) -> float:
    """Share of its SM one CTA can drive: its warps over the SM's
    schedulers (at most 1)."""
    return min(1.0, _ceil_div(attn_threads(p, c), 32)
               / gpu.schedulers_per_sm)


def attn_fill(p: AttnProblem, c: AttnBlock, ctas: int,
              gpu: hwmodel.GPUSpec = hwmodel.H100) -> float:
    """Share of the card a launch of ``ctas`` CTAs keeps busy, the wave
    quantisation of the port's attention: the CTAs run in waves of
    ``attn_resident_ctas`` on each of the 132 SMs, and an SM runs at its
    rate once each of its schedulers has a warp. So the share is the warps
    an SM holds, averaged over the launch's waves, over its schedulers
    (at most 1). A CTA is 1 to 8 warps here, so warps, not the GEMM's CTA
    slots (``tile_efficiency``), measure an SM's share: a 64-row query
    block on an SM alone keeps its 4 schedulers busy, as four 16-row ones
    do."""
    if ctas <= 0:
        return 1.0
    waves = attn_waves(p, c, ctas, gpu)
    warps = _ceil_div(attn_threads(p, c), 32)
    return min(1.0, ctas * warps / (waves * gpu.sms * gpu.schedulers_per_sm))


def _attn_work(p: AttnProblem, c: AttnBlock,
               page_size: Optional[int] = None) -> dict:
    """What tile ``c`` does on problem ``p``, from shapes: the products it
    issues (a query block is padded to ``block_q`` rows, so its products
    cost the whole block: ``tile_rows_used`` is the used share, 5 of 64 at
    the speculative verify's width on the 64-row block), the bytes it
    moves, its CTAs and, with ``page_size``, the page-table entries its
    rows read (one a page a row, which the serving models price at
    ``page_lookup_s``).

    Prefill: K/V tiles are read once a visited (query block, key tile)
    step of each row; the grid is flattened over *q* heads, so under GQA a
    kv head's K/V are read once a q head. Decode: the grid is (kv head x
    query block, slot, split); each CTA row scores its rows in 16-row warp
    tiles, and each split writes its fp32 partial (acc, m, l: d + 2 floats
    a query row), which the merge reads back (``flash_decode._partials``):
    a shorter split fills more of the card and moves more partials."""
    rows = p.batch * p.n_heads
    if p.kernel == DECODE:
        split = _decode_kernel.split_rows(c.block_k, p.page_size)
        n_splits = _ceil_div(p.skv, split)
        q_blocks = _ceil_div(p.sq, c.block_q)
        bk = _decode_kernel.WARP_ROWS
        visited = q_blocks * _ceil_div(p.skv, bk)
        cta_steps = _ceil_div(min(split, p.skv), bk)     # one split
        ctas = rows * q_blocks * n_splits
        partial_bytes = 2 * 4 * rows * p.sq * n_splits * (p.head_dim + 2)
        cta_partial = 2 * 4 * min(c.block_q, p.sq) * (p.head_dim + 2)
    else:
        visited = _attn_visited_blocks(p, c)
        bk = min(c.block_k, p.skv)
        cta_steps = _ceil_div(p.skv, c.block_k)   # the last query block's
        ctas = rows * _ceil_div(p.sq, c.block_q)
        partial_bytes = cta_partial = 0
    bq = min(c.block_q, p.sq)
    flops = rows * visited * 4.0 * bq * bk * p.head_dim
    used = bq / c.block_q
    qo_bytes = rows * 2 * p.sq * p.head_dim * p.in_bytes
    kv_bytes = rows * visited * 2 * bk * p.head_dim * p.in_bytes
    lookups = rows * _attn_visited_blocks(
        p, AttnBlock(c.block_q, page_size)) if page_size else 0
    return {"flops": flops, "issued_flops": flops / used,
            "traffic_bytes": qo_bytes + kv_bytes + partial_bytes,
            "partial_bytes": partial_bytes, "ctas": ctas,
            "cta_issued_flops": cta_steps * 4.0 * c.block_q * bk
            * p.head_dim,
            "cta_bytes": (cta_steps * 2 * bk + 2 * bq) * p.head_dim
            * p.in_bytes + cta_partial,
            "visited_blocks": visited, "tile_rows_used": used,
            "page_lookups": lookups}


def _price(p: AttnProblem, c: AttnBlock, work: dict,
           gpu: hwmodel.GPUSpec, grid_ctas: Optional[int] = None) -> dict:
    """Time of ``work`` (one launch of tile ``c``): the larger of the
    issued operations over the engine's peak (the tensor cores' bf16 rate,
    or the CUDA cores' fp32 FFMA rate) and the bytes over the memory rate.
    Each is the larger of two: the launch's whole work at the share of
    the card its CTAs fill (``attn_fill``, over ``grid_ctas``, the grid's
    CTAs, where they differ from the CTAs that do work), and its critical
    path, the longest CTA's work once a wave at the share of one SM that
    CTA drives (``cta_share``). A launch that leaves SMs idle neither
    computes nor loads at the card's rate, and is as long as its longest
    CTA: more rows never cost less."""
    ctas = work["ctas"] if grid_ctas is None else grid_ctas
    fill = attn_fill(p, c, ctas, gpu)
    path = attn_waves(p, c, ctas, gpu) * gpu.sms / cta_share(p, c, gpu)
    peak = peak_flops(p.in_bytes, gpu)
    compute_s = max(work["issued_flops"] / (peak * fill),
                    path * work["cta_issued_flops"] / peak)
    memory_s = max(work["traffic_bytes"] / (gpu.hbm_bandwidth * fill),
                   path * work["cta_bytes"] / gpu.hbm_bandwidth)
    return dict(work, time_s=max(compute_s, memory_s), compute_s=compute_s,
                memory_s=memory_s, fill=fill)


def attn_cost(p: AttnProblem, c: AttnBlock,
              gpu: hwmodel.GPUSpec = hwmodel.H100,
              page_size: Optional[int] = None) -> Tuple[float, dict]:
    """Modelled time (seconds) of the port's kernel running tile ``c`` on
    problem ``p``, plus terms (``_attn_work``, ``_price``): the port's
    counterpart of the reference's MXU efficiency is the padded query
    block's used share times the fill of the card (``attn_fill``)."""
    terms = _price(p, c, _attn_work(p, c, page_size), gpu)
    return terms["time_s"], terms


def candidate_attn_blocks(p: AttnProblem,
                          gpu: hwmodel.GPUSpec = hwmodel.H100,
                          smem_fraction: float = 1.0) -> List[AttnBlock]:
    """The tiles the build instantiates for the kernel ``p`` runs whose
    staged tiles fit ``smem_fraction`` of one block's shared memory (the
    reference's VMEM budget). Prefill: each of ``BLOCK_QS`` by ``TILE_K``.
    Decode: the dtype's one query block by each split of
    ``SPLIT_ROWS_SET`` that rounds to its own whole pages (the largest of
    those that round alike). None fits: the kernel's naive tile, as the
    reference falls back to its own."""
    budget = int(gpu.smem_per_block * smem_fraction)
    if p.kernel == DECODE:
        bq = _decode_kernel.QUERY_BLOCK[DTYPE_OF[p.in_bytes]]
        seen, cands = set(), []
        for rows in sorted(_decode_kernel.SPLIT_ROWS_SET, reverse=True):
            run = _decode_kernel.split_rows(rows, p.page_size)
            if run not in seen:
                seen.add(run)
                cands.append(AttnBlock(bq, rows))
        cands.reverse()
    else:
        cands = [AttnBlock(bq, _prefill_kernel.TILE_K)
                 for bq in _prefill_kernel.BLOCK_QS]
    out = [c for c in cands if attn_smem_bytes(p, c) <= budget]
    return out or [naive_attn_block(p)]


# The tile every prefill ran before the port chose one (its one compiled
# query block of 64 rows).
NAIVE_ATTN_BLOCK = AttnBlock(64, _prefill_kernel.TILE_K)


def naive_attn_block(p: AttnProblem) -> AttnBlock:
    """The tile the kernel ``p`` runs ran before the chooser: the
    prefill's ``NAIVE_ATTN_BLOCK``; the decode's query block in splits of
    ``SPLIT_ROWS``."""
    if p.kernel == DECODE:
        return AttnBlock(_decode_kernel.QUERY_BLOCK[DTYPE_OF[p.in_bytes]],
                         _decode_kernel.SPLIT_ROWS)
    return NAIVE_ATTN_BLOCK


def decode_problem(batch: int, n_heads: int, n_kv_heads: int, head_dim: int,
                   max_rows: int, in_bytes: int = 2,
                   page_size: int = 1) -> AttnProblem:
    """The problem a decode wrapper builds from shapes, as the reference's
    do: the group's rows of each kv head, over the cache's reach
    (``max_len``, or ``max_pages * page_size``)."""
    return AttnProblem(sq=max(1, n_heads // n_kv_heads), skv=max(1, max_rows),
                       n_heads=n_kv_heads, head_dim=head_dim, batch=batch,
                       causal=False, in_bytes=in_bytes, kernel=DECODE,
                       page_size=page_size)


def _launch(parts: List[dict], p: AttnProblem, c: AttnBlock,
            gpu: hwmodel.GPUSpec, grid_ctas: Optional[int] = None) -> dict:
    """One launch of tile ``c`` over several problems (the slots of a
    decode or verify step, each its own ``_attn_work``): their operations,
    bytes and CTAs summed, then priced at the launch's fill."""
    keys = ("flops", "issued_flops", "traffic_bytes", "partial_bytes",
            "ctas", "visited_blocks", "page_lookups")
    work = {k: sum(t[k] for t in parts) for k in keys}
    for k in ("cta_issued_flops", "cta_bytes"):
        work[k] = max((t[k] for t in parts), default=0)
    out = _price(p, c, work, gpu, grid_ctas)
    out["tile"] = (c.block_q, c.block_k)
    return out


def decode_launch(lengths: Iterable[int], n_heads: int, n_kv_heads: int,
                  head_dim: int, page_size: Optional[int] = None,
                  in_bytes: int = 2,
                  gpu: hwmodel.GPUSpec = hwmodel.H100,
                  max_len: Optional[int] = None,
                  tile: Optional[AttnBlock] = None) -> dict:
    """One launch of the split decode over slots of live context
    ``lengths``: each slot's (kv head, query block) rows read the K/V rows
    its length reaches (``page_lookups`` counts the table entries, on the
    paged layout). The grid, and so the tile and the fill, come from the
    shapes: the cache's reach ``max_len`` (None: the longest length), in
    whole pages. ``tile``: None prices the one
    ``choose_attn_block(..., use_cache=False)`` picks, as the wrapper
    launches."""
    lengths = [int(n) for n in lengths]
    page = page_size or 1
    reach = _ceil_div(max(max_len or max(lengths, default=1), 1), page) * page
    p = decode_problem(len(lengths), n_heads, n_kv_heads, head_dim, reach,
                       in_bytes, page)
    if tile is None:
        tile, _ = choose_attn_block(p, gpu, use_cache=False)
    parts = [_attn_work(dataclasses.replace(p, batch=1, skv=max(n, 1)), tile,
                        page_size) for n in lengths]
    return _launch(parts, p, tile, gpu, _attn_work(p, tile)["ctas"])


def prefill_launch(starts: Iterable[int], sq: int, n_heads: int,
                   head_dim: int, page_size: Optional[int] = None,
                   in_bytes: int = 2,
                   gpu: hwmodel.GPUSpec = hwmodel.H100,
                   max_rows: Optional[int] = None,
                   tile: Optional[AttnBlock] = None) -> dict:
    """One launch of the prefill body: ``sq`` query rows a slot written
    from each slot's ``starts`` and attended causally (a chunk, or the
    verify at sq = k + 1). ``tile``: None prices the one
    ``choose_attn_block(..., use_cache=False)`` picks for the wrapper's
    problem, the pool's reach ``max_rows`` (None: the furthest row a slot
    writes) against sq rows."""
    starts = [int(s) for s in starts]
    if tile is None:
        reach = max_rows or max(starts, default=0) + sq
        tile, _ = choose_attn_block(AttnProblem(
            sq=sq, skv=max(reach, sq), n_heads=n_heads, head_dim=head_dim,
            batch=len(starts), causal=True, in_bytes=in_bytes), gpu,
            use_cache=False)
    p = AttnProblem(sq=sq, skv=sq, n_heads=n_heads, head_dim=head_dim,
                    causal=True, in_bytes=in_bytes)
    return _launch([_attn_work(dataclasses.replace(p, skv=s + sq), tile,
                               page_size) for s in starts], p, tile, gpu)


# ----------------------------------------------------------------------------
# The tuning cache, and the serving path's constants: hand-set defaults and
# calibrated values.
# ----------------------------------------------------------------------------

# The port's own file (under build/, which git ignores); the reference's
# cache is the reference's. Every write replaces the file whole; a file that
# does not parse is discarded.
_REPO_ROOT = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", ".."))
TUNING_CACHE_ENV = "REPRO_TORCH_TUNING_CACHE"
TUNING_CACHE_PATH = os.environ.get(
    TUNING_CACHE_ENV, os.path.join(_REPO_ROOT, "build", "tuning_cache.json"))
_tuning_cache: Optional[dict] = None


def _backend_key(backend: Optional[str] = None) -> str:
    """``"cuda"`` or ``"cpu"``: the device type the constants were (or are
    to be) measured on; None is the process's default device."""
    if backend is not None:
        return backend
    return "cuda" if torch.cuda.is_available() else "cpu"


def _mesh_key(mesh_shape=None) -> str:
    """A cache-key token for the devices a measurement spans: None keys by
    the visible CUDA device count (``dev1`` without CUDA); a string is
    used as it is; an ``{axis: size}`` mapping or a shape names a mesh."""
    if mesh_shape is None:
        return f"dev{max(1, torch.cuda.device_count())}"
    if isinstance(mesh_shape, str):
        return mesh_shape
    shape = getattr(mesh_shape, "shape", mesh_shape)
    if hasattr(shape, "items"):
        return "mesh(" + ",".join(
            f"{a}={int(n)}" for a, n in sorted(dict(shape).items())) + ")"
    return "mesh(" + ",".join(str(int(n)) for n in tuple(shape)) + ")"


def _load_tuning_cache() -> dict:
    global _tuning_cache
    if _tuning_cache is None:
        try:
            with open(TUNING_CACHE_PATH) as f:
                loaded = json.load(f)
            if not isinstance(loaded, dict):
                raise ValueError(
                    f"cache root is {type(loaded).__name__}, not object")
            _tuning_cache = loaded
        except OSError:
            # Missing or unreadable: leave the file alone.
            _tuning_cache = {}
        except ValueError:
            # A torn write, a truncated file or a non-object root: discard
            # it (the next write rebuilds it) and use the defaults.
            _tuning_cache = {}
            try:
                os.remove(TUNING_CACHE_PATH)
            except OSError:
                pass
    return _tuning_cache


def _store_tuning_cache(key: str, entry: dict) -> None:
    """Write-through of one entry: the whole cache to a temporary file in
    the same directory, then an atomic replace."""
    cache = _load_tuning_cache()
    cache[key] = entry
    try:
        os.makedirs(os.path.dirname(TUNING_CACHE_PATH), exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(TUNING_CACHE_PATH),
                                   suffix=".tmp")
        with os.fdopen(fd, "w") as f:
            json.dump(cache, f, indent=1, sort_keys=True)
        os.replace(tmp, TUNING_CACHE_PATH)
    except OSError:
        pass                       # a read-only checkout: in memory only


# Measured serving spans (``serve.telemetry.drift_report(persist=True)``)
# share the cache under their own namespace: {"time_s", "modeled_s",
# "ratio", "n", "source"}.
SERVE_MEASURED_PREFIX = "serve_measured:"


def record_serve_measurement(name: str, entry: dict) -> None:
    """Persist one measured serving-span entry (keyed by component and
    engine geometry) into the tuning cache."""
    assert isinstance(entry.get("time_s"), float) and entry["time_s"] > 0, \
        entry
    _store_tuning_cache(SERVE_MEASURED_PREFIX + name, dict(entry))


def load_serve_measurement(name: str) -> Optional[dict]:
    return _load_tuning_cache().get(SERVE_MEASURED_PREFIX + name)


def drift_ratio(measured_s: float, modeled_s: float) -> float:
    """measured / modelled, with 0.0 for a missing or degenerate input (a
    gate that wants the ratio finite and positive then fails, rather than
    passing an inf or a NaN)."""
    if not (math.isfinite(measured_s) and math.isfinite(modeled_s)):
        return 0.0
    if measured_s <= 0.0 or modeled_s <= 0.0:
        return 0.0
    return measured_s / modeled_s


# The attention tile chooser: the cheapest candidate in the model, kept in
# the tuning cache under a key naming the card, the devices and the problem.
# Hits are memoised in process (``_attn_memo``, kept while the parsed cache
# it came from is the one in use), so a wrapper called once a layer costs
# no file I/O and no pricing after a problem's first call.
_attn_memo: dict = {}
_attn_memo_of: Optional[dict] = None


def _cache_key(p: AttnProblem, gpu: hwmodel.GPUSpec = hwmodel.H100,
               mesh_shape=None) -> str:
    return (f"{gpu.name}:{_mesh_key(mesh_shape)}:sq={p.sq}:skv={p.skv}"
            f":h={p.n_heads}:d={p.head_dim}:b={p.batch}"
            f":causal={int(p.causal)}:bytes={p.in_bytes}"
            f":kernel={p.kernel}:page={p.page_size}")


def choose_attn_block(p: AttnProblem,
                      gpu: hwmodel.GPUSpec = hwmodel.H100,
                      use_cache: bool = True,
                      mesh_shape=None) -> Tuple[AttnBlock, dict]:
    """Minimum-modelled-time tile of ``candidate_attn_blocks``, persisted
    across processes (the reference's contract).

    The key names the card (``gpu.name``), the devices (``mesh_shape``;
    None: the process's CUDA device count) and every field of the problem,
    so single- and multi-device runs keep separate entries. Write-through;
    a torn file or a malformed entry is a miss that the write overwrites;
    a hit outside today's candidates is re-derived; ``terms["cached"]``
    marks a hit. Shapes only: nothing of a launch's data is read."""
    global _attn_memo, _attn_memo_of
    key = _cache_key(p, gpu, mesh_shape)
    if use_cache:
        cache = _load_tuning_cache()
        if _attn_memo_of is not cache:
            _attn_memo, _attn_memo_of = {}, cache
        memo = _attn_memo.get(key)
        if memo is not None:
            return memo[0], dict(memo[1])
        hit = cache.get(key)
        if hit is not None:
            try:
                blk = AttnBlock(int(hit["block_q"]), int(hit["block_k"]))
                terms, time_s = dict(hit["terms"]), float(hit["time_s"])
            except (KeyError, TypeError, ValueError):
                hit = None
            if hit is not None and blk in candidate_attn_blocks(p, gpu):
                terms = dict(terms, time_s=time_s, cached=True)
                _attn_memo[key] = (blk, terms)
                return blk, dict(terms)
    best, best_t, best_terms = None, float("inf"), None
    for c in candidate_attn_blocks(p, gpu):
        t, terms = attn_cost(p, c, gpu)
        if t < best_t:
            best, best_t, best_terms = c, t, terms
    if use_cache:
        _store_tuning_cache(key, {"block_q": best.block_q,
                                  "block_k": best.block_k,
                                  "time_s": best_t, "terms": best_terms})
    return best, dict(best_terms, time_s=best_t)


def decode_attn_speedup(max_len: int, lengths: Iterable[int], n_heads: int,
                        n_kv_heads: int, head_dim: int,
                        gpu: hwmodel.GPUSpec = hwmodel.H100) -> dict:
    """Modelled naive-vs-fast decode attention for one engine tick.

    Naive: every slot attends over the full ``max_len`` cache (the seed
    engine's behaviour). Fast: the split decode reads each slot's rows up
    to its length. Both are one launch of the tile the chooser picks for
    the cache's shape (the grid is sized from ``max_len`` either way)."""
    lengths = [int(n) for n in lengths]
    naive = decode_launch([max_len] * len(lengths), n_heads, n_kv_heads,
                          head_dim, gpu=gpu, max_len=max_len)["time_s"]
    fast = decode_launch(lengths, n_heads, n_kv_heads, head_dim, gpu=gpu,
                         max_len=max_len)["time_s"]
    return {"naive_s": naive, "fast_s": fast,
            "speedup": naive / fast if fast else float("inf")}


# Hand-set defaults: assumptions, each replaced by a measurement on the
# device once ``core.calibrate`` has run there.
#
# Reading one page-table entry while a decode or prefill CTA walks a page of
# K/V: one 4-byte load, staged with the rest of the CTA's span while the
# launch's CTAs overlap; assumed half a nanosecond of launch time.
PAGE_LOOKUP_S = 5e-10

# Dispatching one prefill chunk step from the host: assumed one CUDA-graph
# replay's launch, the fixed cost a small chunk pays more often.
CHUNK_DISPATCH_S = 2e-5

# Host cost of one prefix-index level: a blake2b digest of a page of
# tokens and a dict probe (``serve.paged.PrefixIndex``).
PREFIX_HASH_S = 2e-6

# Host cost of one n-gram drafted token (a numpy scan of the slot's
# history).
NGRAM_DRAFT_S = 2e-6

# Calibrated constants persist in the tuning cache, one schema-versioned
# entry a (backend, devices, constant):
#
#   calibrated:cuda:dev1:page_lookup_s ->
#     {"schema_version": 1, "value": ..., "n_trials": ..., "spread": ...,
#      "backend": "cuda", "mesh": "dev1", "timestamp": ..., ...}
#
# ``resolve_constants`` reads them back constant by constant: a torn or
# misversioned entry falls back to that constant's default alone.
CALIBRATED_PREFIX = "calibrated:"
CALIBRATION_SCHEMA_VERSION = 1

# Set (to anything but "" or "0"), the hand-set defaults are used and every
# ``calibrated:`` entry is skipped; the serve launcher's
# ``--default-constants`` sets it.
DEFAULT_CONSTANTS_ENV = "REPRO_DEFAULT_CONSTANTS"


@dataclasses.dataclass(frozen=True)
class ServeConstants:
    """One resolved set of serving-path cost constants.

    ``source`` is ``"default"`` (the hand-set constants) or
    ``"calibrated"`` (``core.calibrate``'s measurements, read back for this
    backend and device count). ``hbm_bandwidth`` and ``dispatch_s`` are None
    in the default set: the models then price streams at the spec's rate
    and add no dispatch term of their own."""

    page_lookup_s: float = PAGE_LOOKUP_S
    chunk_dispatch_s: float = CHUNK_DISPATCH_S
    prefix_hash_s: float = PREFIX_HASH_S
    draft_token_s: float = NGRAM_DRAFT_S
    dispatch_s: Optional[float] = None     # measured launch round trip
    hbm_bandwidth: Optional[float] = None  # None -> the GPUSpec's rate
    source: str = "default"                # "default" | "calibrated"
    backend: str = ""
    mesh: str = ""
    timestamp: float = 0.0

    def apply_gpu(self, gpu: hwmodel.GPUSpec) -> hwmodel.GPUSpec:
        """The spec the models price streams with: the measured stream
        rate when calibrated, the spec itself otherwise."""
        if self.hbm_bandwidth is None:
            return gpu
        return dataclasses.replace(gpu, hbm_bandwidth=self.hbm_bandwidth)


DEFAULT_CONSTANTS = ServeConstants()

# Probe targets, in report order.
CALIBRATED_NAMES = ("dispatch_s", "page_lookup_s", "hbm_bandwidth",
                    "chunk_dispatch_s", "draft_token_s", "prefix_hash_s")


def assumed_constants(gpu: hwmodel.GPUSpec = hwmodel.H100) -> dict:
    """The hand-set value of each calibrated constant (the drift baseline).
    ``dispatch_s`` has no model term; its baseline is the chunk dispatch,
    which prices the same host launch."""
    return {"dispatch_s": CHUNK_DISPATCH_S,
            "page_lookup_s": PAGE_LOOKUP_S,
            "hbm_bandwidth": gpu.hbm_bandwidth,
            "chunk_dispatch_s": CHUNK_DISPATCH_S,
            "draft_token_s": NGRAM_DRAFT_S,
            "prefix_hash_s": PREFIX_HASH_S}


def calibration_key(name: str, mesh_shape=None,
                    backend: Optional[str] = None) -> str:
    return (f"{CALIBRATED_PREFIX}{_backend_key(backend)}"
            f":{_mesh_key(mesh_shape)}:{name}")


def record_calibration(name: str, value: float, mesh_shape=None,
                       backend: Optional[str] = None, **meta) -> None:
    """Persist one probed constant under the ``calibrated:`` namespace."""
    assert name in CALIBRATED_NAMES, name
    value = float(value)
    assert math.isfinite(value) and value > 0, (name, value)
    entry = {"schema_version": CALIBRATION_SCHEMA_VERSION,
             "value": value,
             "backend": _backend_key(backend),
             "mesh": _mesh_key(mesh_shape)}
    entry.update(meta)
    _store_tuning_cache(calibration_key(name, mesh_shape, backend), entry)


def load_calibration(name: str, mesh_shape=None,
                     backend: Optional[str] = None) -> Optional[dict]:
    """One constant's valid cache entry, or None: a torn entry, another
    schema version or a value that is not finite and positive reads as
    None (that constant keeps its default), never as an exception."""
    hit = _load_tuning_cache().get(
        calibration_key(name, mesh_shape, backend))
    if not isinstance(hit, dict):
        return None
    try:
        if int(hit["schema_version"]) != CALIBRATION_SCHEMA_VERSION:
            return None
        v = float(hit["value"])
    except (KeyError, TypeError, ValueError):
        return None
    if not (math.isfinite(v) and v > 0):
        return None
    return hit


def resolve_constants(mesh_shape=None,
                      backend: Optional[str] = None) -> ServeConstants:
    """The constants the serving engine prices its decisions with: each
    calibrated one that has a valid entry for this backend and device
    count, the hand-set default for the rest. With
    ``REPRO_DEFAULT_CONSTANTS`` set, or no valid entry at all, exactly
    ``DEFAULT_CONSTANTS``."""
    if os.environ.get(DEFAULT_CONSTANTS_ENV, "").strip() not in ("", "0"):
        return DEFAULT_CONSTANTS
    found, ts = {}, 0.0
    for name in CALIBRATED_NAMES:
        hit = load_calibration(name, mesh_shape, backend)
        if hit is not None:
            found[name] = float(hit["value"])
            try:
                ts = max(ts, float(hit.get("timestamp", 0.0)))
            except (TypeError, ValueError):
                pass
    if not found:
        return DEFAULT_CONSTANTS
    return dataclasses.replace(DEFAULT_CONSTANTS, source="calibrated",
                               backend=_backend_key(backend),
                               mesh=_mesh_key(mesh_shape),
                               timestamp=ts, **found)


def calibration_report(mesh_shape=None, backend: Optional[str] = None,
                       gpu: hwmodel.GPUSpec = hwmodel.H100) -> dict:
    """Measured against assumed, a constant a row: the measured value (None
    when never calibrated), the hand-set one, their drift ratio (0.0 when
    unmeasured) and the probe's n_trials, spread and timestamp."""
    resolved = resolve_constants(mesh_shape, backend)
    assumed = assumed_constants(gpu)
    rows = {}
    for name in CALIBRATED_NAMES:
        hit = load_calibration(name, mesh_shape, backend)
        measured = float(hit["value"]) if hit is not None else None
        rows[name] = {
            "assumed": assumed[name],
            "measured": measured,
            "drift_ratio": drift_ratio(measured, assumed[name])
            if measured is not None else 0.0,
            "n_trials": hit.get("n_trials") if hit else None,
            "spread": hit.get("spread") if hit else None,
            "timestamp": hit.get("timestamp") if hit else None,
        }
    return {"schema_version": CALIBRATION_SCHEMA_VERSION,
            "source": resolved.source,
            "backend": _backend_key(backend),
            "mesh": _mesh_key(mesh_shape),
            "timestamp": resolved.timestamp,
            "constants": rows}


# ----------------------------------------------------------------------------
# Serving cost models and choosers (one device, or tensor-parallel).
# ----------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TPServe:
    """Tensor-parallel serving geometry for the cost models.

    ``n_devices`` shards the weight stream, the dense operations and
    (where the head count divides) the attention; each layer pays two
    activation all-reduces (the output projection and the MLP's down
    projection, the row-parallel cut) and the forward ends with one
    all-gather of the logits' vocab columns."""
    n_devices: int
    d_model: int
    n_layers: int


def _tp_collective_s(tokens: float, tp: Optional[TPServe], in_bytes: int,
                     link: hwmodel.LinkSpec = hwmodel.H100_NVLINK4
                     ) -> float:
    """Collective seconds of one forward of ``tokens`` query tokens under
    ``tp``, priced on ``link``; 0 without it (the one-device models stay
    as they are)."""
    if tp is None or tp.n_devices <= 1:
        return 0.0
    from repro_torch.core import interconnect
    payload = float(tokens) * tp.d_model * in_bytes
    ar = interconnect.collective_time("all_reduce", payload,
                                      tp.n_devices, link).time_s
    ag = interconnect.collective_time("all_gather", payload,
                                      tp.n_devices, link).time_s
    return 2.0 * tp.n_layers * ar + ag


def _tp_shard(tp: Optional[TPServe], heads: int) -> Tuple[int, int]:
    """(dense shard factor, attention shard factor) under ``tp``: the
    attention's is 1 where ``heads`` does not divide the devices, the
    divisibility rule of ``dist.sharding``."""
    if tp is None or tp.n_devices <= 1:
        return 1, 1
    d = tp.n_devices
    return d, (d if heads % d == 0 else 1)



def paged_decode_model(max_len: int, lengths: Iterable[int], n_heads: int,
                       n_kv_heads: int, head_dim: int, page_size: int,
                       in_bytes: int = 2,
                       page_lookup_s: Optional[float] = None,
                       tp: Optional[TPServe] = None,
                       constants: Optional[ServeConstants] = None,
                       gpu: hwmodel.GPUSpec = hwmodel.H100) -> dict:
    """Paged against contiguous decode attention for one engine tick (one
    layer's launch of the split decode): the same work, a page-table
    lookup for each page a (slot, kv head) reads, and a reservation that
    drops from ``slots * max_len`` rows to the pages the live contexts
    touch (and the null page). The paper's paging trade: finer pages waste
    less capacity and pay more translation.

    Under ``tp`` the attention shards over kv heads (where they divide
    the devices) and both layouts pay the tick's activation collectives
    (``collective_s``): paging and tensor parallelism compose.

    ``constants`` supplies the lookup cost and, calibrated, the measured
    stream rate; None is the hand-set set. ``page_lookup_s`` overrides."""
    from repro_torch.serve.paged import reservation

    const = constants if constants is not None else DEFAULT_CONSTANTS
    gpu = const.apply_gpu(gpu)
    if page_lookup_s is None:
        page_lookup_s = const.page_lookup_s
    lengths = [int(n) for n in lengths]
    slots = len(lengths)
    launch = decode_launch(lengths, n_heads, n_kv_heads, head_dim,
                           page_size, in_bytes, gpu, max_len=max_len)
    _, attn_shard = _tp_shard(tp, n_kv_heads)
    collective_s = _tp_collective_s(slots, tp, in_bytes)
    contig_s = launch["time_s"] / attn_shard + collective_s
    paged_s = (launch["time_s"] + launch["page_lookups"] * page_lookup_s) \
        / attn_shard + collective_s
    block_q, block_k = launch["tile"]
    rows, n_splits = _decode_kernel.splits(max_len, page_size, block_k)
    group = max(1, n_heads // n_kv_heads)
    q_blocks = _ceil_div(group, block_q)

    out = reservation(lengths, max_len, page_size)   # the one accounting
    bytes_per_row = 2 * n_kv_heads * head_dim * in_bytes     # K + V
    out.update({
        "collective_s": collective_s,
        "contig_s": contig_s,
        "paged_s": paged_s,
        "lookup_overhead_frac": (paged_s - contig_s) / contig_s
        if contig_s else 0.0,
        "visited_blocks": launch["page_lookups"],
        "ctas": slots * n_kv_heads * q_blocks * n_splits,
        "split_rows": rows,
        "tile": launch["tile"],
        "tokens_per_s_contig": slots / contig_s if contig_s else 0.0,
        "tokens_per_s_paged": slots / paged_s if paged_s else 0.0,
        "hbm_paged_bytes_per_layer": out["rows_resident"] * bytes_per_row,
        "hbm_contig_bytes_per_layer":
            out["rows_reserved_contig"] * bytes_per_row,
    })
    return out


def prefill_chunk_model(prompt_len: int, chunk: int, n_heads: int,
                        n_kv_heads: int, head_dim: int, page_size: int,
                        in_bytes: int = 2,
                        page_lookup_s: Optional[float] = None,
                        cached_rows: int = 0,
                        tp: Optional[TPServe] = None,
                        constants: Optional[ServeConstants] = None,
                        gpu: hwmodel.GPUSpec = hwmodel.H100) -> dict:
    """Chunked paged prefill of one ``prompt_len`` prompt at one chunk
    size: each chunk's causal attention (one launch of the prefill body at
    sq = chunk, written from the chunk's start: a padded last chunk runs
    its whole width, as the engine's step does), a page-table lookup for
    each page a CTA reads, and a dispatch cost a chunk.

    Big chunks amortise dispatch and fill the query tiles but stall the
    interleaved decode ticks for a whole chunk (``interleave_latency_s``,
    the longest chunk); small chunks keep decode latency tight and pay
    the fixed costs more often.

    ``cached_rows`` prices a prefix-cache hit: prefill starts at the
    cached cursor, every later chunk still attends the cached rows, and a
    hash-probe term charges the index walk. ``n_kv_heads`` does not change
    the traffic: the prefill grid is over *q* heads, so K/V are read once
    a q head. Under ``tp`` the attention shards over q heads where they
    divide the devices, and every chunk pays the activation collectives
    (a fixed cost a chunk, which small chunks amortise badly)."""
    const = constants if constants is not None else DEFAULT_CONSTANTS
    gpu = const.apply_gpu(gpu)
    if page_lookup_s is None:
        page_lookup_s = const.page_lookup_s
    dispatch_s = const.chunk_dispatch_s
    del n_kv_heads
    _, attn_shard = _tp_shard(tp, n_heads)
    coll_per_chunk = _tp_collective_s(chunk, tp, in_bytes)
    # A prompt cached whole still prefills its last row (its logit is
    # sampled): the engine's clamp.
    cached_rows = max(0, min(int(cached_rows), prompt_len - 1))
    probe_s = _ceil_div(cached_rows, page_size) * const.prefix_hash_s
    n_chunks = _ceil_div(prompt_len - cached_rows, chunk)
    # The chunk step's one tile: the chooser's for the wrapper's problem,
    # a chunk against the prompt's reach in whole pages.
    reach = max(_ceil_div(prompt_len, page_size) * page_size, chunk)
    tile, _ = choose_attn_block(AttnProblem(
        sq=chunk, skv=reach, n_heads=n_heads, head_dim=head_dim,
        causal=True, in_bytes=in_bytes), gpu, use_cache=False)
    attn_s, lookup_s, visited_total, worst_chunk_s = 0.0, 0.0, 0, 0.0
    for i in range(n_chunks):
        launch = prefill_launch([cached_rows + i * chunk], chunk, n_heads,
                                head_dim, page_size, in_bytes, gpu,
                                tile=tile)
        t, visited = launch["time_s"] / attn_shard, launch["page_lookups"]
        attn_s += t
        lookup_s += visited * page_lookup_s
        visited_total += visited
        worst_chunk_s = max(worst_chunk_s, t + visited * page_lookup_s
                            + dispatch_s + coll_per_chunk)
    collective_s = n_chunks * coll_per_chunk
    total_s = attn_s + lookup_s + n_chunks * dispatch_s + collective_s \
        + probe_s
    return {
        "chunk": chunk,
        "n_chunks": n_chunks,
        "collective_s": collective_s,
        "cached_rows": cached_rows,
        "probe_s": probe_s,
        "prefill_s": total_s,
        "attn_s": attn_s,
        "lookup_s": lookup_s,
        "dispatch_s": n_chunks * dispatch_s,
        "visited_blocks": visited_total,
        "interleave_latency_s": worst_chunk_s,
        "lookup_overhead_frac": lookup_s / attn_s if attn_s else 0.0,
        "tile": (tile.block_q, tile.block_k),
    }


def choose_prefill_chunk(max_len: int, n_heads: int, n_kv_heads: int,
                         head_dim: int, page_size: int,
                         latency_weight: float = 4.0,
                         in_bytes: int = 2,
                         constants: Optional[ServeConstants] = None,
                         gpu: hwmodel.GPUSpec = hwmodel.H100
                         ) -> Tuple[int, dict]:
    """The chunk size the serving engine prefills with when
    ``ServeConfig.chunk_size`` is None. Candidates are ``page_size`` times
    the powers of two up to ``max_len`` (and ``max_len``); the score is
    the whole-prompt prefill time plus ``latency_weight`` times the
    interleave latency (each decode slot waits out a chunk between its
    tokens while a prompt streams)."""
    assert 0 < page_size <= max_len, \
        ("chunked prefill needs at least one page per chunk",
         page_size, max_len)
    cands = []
    c = page_size
    while c <= max_len:
        cands.append(c)
        c *= 2
    if cands[-1] != max_len and max_len % page_size == 0:
        cands.append(max_len)
    best, best_score, best_terms = None, float("inf"), None
    for cand in cands:
        terms = prefill_chunk_model(max_len, cand, n_heads, n_kv_heads,
                                    head_dim, page_size, in_bytes=in_bytes,
                                    constants=constants, gpu=gpu)
        score = terms["prefill_s"] \
            + latency_weight * terms["interleave_latency_s"]
        if score < best_score:
            best, best_score, best_terms = cand, score, terms
    return best, dict(best_terms, score_s=best_score,
                      candidates=len(cands))


def choose_prefix_cache(prompt_len: int, prefix_rows: int, hit_rate: float,
                        n_heads: int, n_kv_heads: int, head_dim: int,
                        page_size: int, chunk: Optional[int] = None,
                        in_bytes: int = 2,
                        constants: Optional[ServeConstants] = None,
                        gpu: hwmodel.GPUSpec = hwmodel.H100
                        ) -> Tuple[bool, dict]:
    """On or off for ``ServeConfig.prefix_cache``, priced by hit rate: a hit
    prefills the suffix past ``prefix_rows`` plus the probe and one
    copy-on-write page split; a miss prefills everything plus the probe
    that found nothing. The cache wins when that mixture beats the
    uncached prefill; at ``hit_rate`` 0 the probe's tax makes "off" the
    choice."""
    assert 0.0 <= hit_rate <= 1.0, hit_rate
    const = constants if constants is not None else DEFAULT_CONSTANTS
    gpu = const.apply_gpu(gpu)
    prefix_rows = max(0, min(int(prefix_rows), int(prompt_len)))
    if chunk is None:
        chunk, _ = choose_prefill_chunk(prompt_len, n_heads, n_kv_heads,
                                        head_dim, page_size,
                                        in_bytes=in_bytes,
                                        constants=const, gpu=gpu)
    full = prefill_chunk_model(prompt_len, chunk, n_heads, n_kv_heads,
                               head_dim, page_size, in_bytes=in_bytes,
                               constants=const, gpu=gpu)
    hit = prefill_chunk_model(prompt_len, chunk, n_heads, n_kv_heads,
                              head_dim, page_size, in_bytes=in_bytes,
                              cached_rows=prefix_rows, constants=const,
                              gpu=gpu)
    # One copy-on-write split: a page of K and V rows read and written.
    cow_s = 4 * page_size * n_kv_heads * head_dim * in_bytes \
        / gpu.hbm_bandwidth
    probe_s = _ceil_div(prompt_len, page_size) * const.prefix_hash_s
    on_s = hit_rate * (hit["prefill_s"] + cow_s) \
        + (1.0 - hit_rate) * (full["prefill_s"] + probe_s)
    off_s = full["prefill_s"]
    return on_s < off_s, {
        "hit_rate": hit_rate,
        "prefix_rows": prefix_rows,
        "chunk": chunk,
        "prefill_s_off": off_s,
        "prefill_s_on": on_s,
        "prefill_s_hit": hit["prefill_s"],
        "cow_s": cow_s,
        "probe_s": probe_s,
        "speedup": off_s / on_s if on_s else float("inf"),
        "ttft_frac_hit": hit["prefill_s"] / off_s if off_s else 0.0,
    }


def expected_spec_tokens(k: int, accept_rate: float) -> float:
    """E[tokens emitted per verify tick] with per-draft accept probability
    ``accept_rate``: the accepted prefix length plus the always-emitted
    bonus/correction token, sum_{i=0..k} a^i. k=0 gives 1 (plain decode)."""
    return sum(accept_rate ** i for i in range(k + 1))


def spec_decode_model(lengths: Iterable[int], n_heads: int,
                      n_kv_heads: int, head_dim: int, page_size: int,
                      k: int, accept_rate: float, param_bytes: float,
                      draft_bytes: float = 0.0,
                      draft_token_s: Optional[float] = None,
                      in_bytes: int = 2,
                      page_lookup_s: Optional[float] = None,
                      plain_tick_s: Optional[float] = None,
                      tp: Optional[TPServe] = None,
                      constants: Optional[ServeConstants] = None,
                      gpu: hwmodel.GPUSpec = hwmodel.H100) -> dict:
    """One speculative verify tick against plain decode ticks: how much
    parallel work (k drafted tokens scored in one pass) amortises the
    fixed serial cost of a tick (streaming every weight once).

    A tick, batch-wide (the reference's terms):

    * ``weight_stream_s``: ``param_bytes`` over the memory rate, once a
      tick whatever its width;
    * attention: a plain tick is the split decode (one launch over the
      slots); a verify of width k + 1 is the prefill body at sq = k + 1
      from each slot's write position (its query block padded to the
      chooser's ``block_q`` rows, K/V read once a q head), with the
      page-table term;
    * dense operations for ``slots * (k + 1)`` tokens at the engine's peak;
    * the chunk-dispatch constant, once a tick;
    * drafting: ``slots * k`` draft weight streams (``draft_bytes``, 0 for
      the n-gram drafter) and host lookups (``draft_token_s``).

    Emitted tokens follow ``expected_spec_tokens``; ``speedup`` is spec
    tokens/s over plain tokens/s. Under ``tp`` each device streams its
    shard of the weights and does its share of the dense operations and
    (where the kv heads divide) of the attention, and the tick pays its
    activation collectives."""
    const = constants if constants is not None else DEFAULT_CONSTANTS
    gpu = const.apply_gpu(gpu)
    if page_lookup_s is None:
        page_lookup_s = const.page_lookup_s
    if draft_token_s is None:
        draft_token_s = const.draft_token_s
    lengths = [int(n) for n in lengths]
    slots = len(lengths)
    dense_shard, attn_shard = _tp_shard(tp, n_kv_heads)
    weight_stream_s = param_bytes / gpu.hbm_bandwidth / dense_shard
    n_params = param_bytes / in_bytes

    def tick_s(width: int) -> float:
        if width == 1:
            launch = decode_launch(lengths, n_heads, n_kv_heads, head_dim,
                                   page_size, in_bytes, gpu)
        else:
            launch = prefill_launch(
                [max(n, 1) - 1 for n in lengths], width, n_heads, head_dim,
                page_size, in_bytes, gpu,
                max_rows=_ceil_div(max(lengths, default=1) + width,
                                   page_size) * page_size)
        attn = (launch["time_s"] + launch["page_lookups"] * page_lookup_s) \
            / attn_shard
        dense = 2.0 * n_params * slots * width \
            / (dense_shard * peak_flops(in_bytes, gpu))
        return weight_stream_s + attn + dense + const.chunk_dispatch_s \
            + _tp_collective_s(slots * width, tp, in_bytes)

    # The width-1 tick does not depend on k: choose_spec_k computes it once.
    plain_tick = plain_tick_s if plain_tick_s is not None else tick_s(1)
    spec_tick = tick_s(k + 1) if k else plain_tick
    draft_s = slots * k * (draft_bytes / gpu.hbm_bandwidth + draft_token_s)
    spec_tick += draft_s
    e_tokens = expected_spec_tokens(k, accept_rate)
    tok_plain = slots / plain_tick
    tok_spec = slots * e_tokens / spec_tick
    return {
        "k": k,
        "accept_rate": accept_rate,
        "expected_tokens_per_tick": e_tokens,
        "weight_stream_s": weight_stream_s,
        "plain_tick_s": plain_tick,
        "spec_tick_s": spec_tick,
        "draft_s": draft_s,
        "verify_overhead_frac": spec_tick / plain_tick - 1.0,
        "tokens_per_s_plain": tok_plain,
        "tokens_per_s_spec": tok_spec,
        "speedup": tok_spec / tok_plain,
    }


def choose_spec_k(lengths: Iterable[int], n_heads: int,
                  n_kv_heads: int, head_dim: int, page_size: int,
                  accept_rate: float, param_bytes: float,
                  draft_bytes: float = 0.0,
                  draft_token_s: Optional[float] = None,
                  ks: Tuple[int, ...] = (1, 2, 3, 4, 6, 8),
                  in_bytes: int = 2,
                  tp: Optional[TPServe] = None,
                  constants: Optional[ServeConstants] = None,
                  gpu: hwmodel.GPUSpec = hwmodel.H100
                  ) -> Tuple[int, dict]:
    """The verify width the engine speculates with: the candidate ``k`` of
    the most modelled tokens/s, or 0 (plain decode) when none beats the
    plain engine, as at a low accept rate or with a draft that costs more
    than the tokens it lands. The terms are the best candidate's either
    way."""
    lengths = list(lengths)
    best_k, best_terms, plain_tick_s = 0, None, None
    for k in ks:
        terms = spec_decode_model(lengths, n_heads, n_kv_heads,
                                  head_dim, page_size, k, accept_rate,
                                  param_bytes, draft_bytes=draft_bytes,
                                  draft_token_s=draft_token_s,
                                  in_bytes=in_bytes,
                                  plain_tick_s=plain_tick_s, tp=tp,
                                  constants=constants, gpu=gpu)
        plain_tick_s = terms["plain_tick_s"]
        if best_terms is None or \
                terms["tokens_per_s_spec"] > best_terms["tokens_per_s_spec"]:
            best_k, best_terms = k, terms
    if best_terms["speedup"] <= 1.0:
        best_k = 0
    return best_k, dict(best_terms, chosen_k=best_k,
                        candidates=len(list(ks)))


# -- serving overload pressure ------------------------------------------------
# Port of the reference's pressure signal and degradation latch
# (``repro/core/autotune.py``): pure functions of floats, which the
# engine's degrade ladder reads each tick.

DEGRADE_HIGH = 0.85   # default enter-degraded threshold (ServeConfig)
DEGRADE_LOW = 0.60    # default leave-degraded threshold (hysteresis)


def serve_pressure(pool_occupancy: float, queue_depth: int,
                   batch: int) -> float:
    """Load pressure in [0, 1]: the worse of the page pool's occupancy
    (pages in use / capacity: near 1 the next decode page comes from a
    preemption) and the queue depth over the decode batch (a queue deeper
    than the batch means arrivals outrun service). ``max``, not a sum:
    either resource saturating alone is an overload."""
    q = min(1.0, float(queue_depth) / max(1.0, float(batch)))
    return max(min(1.0, float(pool_occupancy)), q)


def choose_degradation(pressure: float, degraded: bool,
                       high: float = DEGRADE_HIGH,
                       low: float = DEGRADE_LOW) -> bool:
    """Hysteresis band of the load-shedding latch: enter degraded mode
    at or above ``high``, leave at or below ``low``. The dead band keeps
    a downshift, which lowers pressure, from flapping back each tick."""
    assert 0.0 <= low <= high <= 1.0, (low, high)
    if degraded:
        return pressure > low
    return pressure >= high


# ----------------------------------------------------------------------------
# Tensor-parallel decode, and the layout of one matmul layer.
# ----------------------------------------------------------------------------

def tp_decode_model(lengths: Iterable[int], n_heads: int,
                    n_kv_heads: int, head_dim: int, page_size: int,
                    param_bytes: float, d_model: int, n_layers: int,
                    n_devices: int, in_bytes: int = 2,
                    page_lookup_s: Optional[float] = None,
                    constants: Optional[ServeConstants] = None,
                    gpu: hwmodel.GPUSpec = hwmodel.H100) -> dict:
    """One paged decode tick on one device against tensor-parallel over
    ``n_devices``: decode streams every weight once a tick, so sharding
    each matrix divides the dominant term by the devices, and what is
    left to pay is the layers' activation all-reduces and the logits'
    gather (``collective_s``), small at decode widths since the payload
    is slots x d_model. The other gain is capacity: the page pool is
    sharded by pages, so the same memory a device holds n_devices times
    the pages (``pool_capacity_ratio``)."""
    lengths = [int(n) for n in lengths]
    slots = len(lengths)
    tp = TPServe(n_devices=n_devices, d_model=d_model, n_layers=n_layers)
    common = dict(n_heads=n_heads, n_kv_heads=n_kv_heads,
                  head_dim=head_dim, page_size=page_size,
                  k=0, accept_rate=0.0, param_bytes=param_bytes,
                  in_bytes=in_bytes, page_lookup_s=page_lookup_s,
                  constants=constants, gpu=gpu)
    base = spec_decode_model(lengths, **common)
    shard = spec_decode_model(lengths, tp=tp, **common)
    tick_1, tick_tp = base["plain_tick_s"], shard["plain_tick_s"]
    collective_s = _tp_collective_s(slots, tp, in_bytes)
    return {
        "n_devices": n_devices,
        "slots": slots,
        "tick_1dev_s": tick_1,
        "tick_tp_s": tick_tp,
        "weight_stream_1dev_s": base["weight_stream_s"],
        "weight_stream_tp_s": shard["weight_stream_s"],
        "collective_s": collective_s,
        "collective_frac": collective_s / tick_tp if tick_tp else 0.0,
        "attn_sharded": n_kv_heads % max(1, n_devices) == 0,
        "tokens_per_s_1dev": slots / tick_1 if tick_1 else 0.0,
        "tokens_per_s_tp": slots / tick_tp if tick_tp else 0.0,
        "speedup": tick_1 / tick_tp if tick_tp else float("inf"),
        "pool_capacity_ratio": float(n_devices),
    }


@dataclasses.dataclass(frozen=True)
class ShardingChoice:
    name: str                   # "dp", "tp_col", "tp_row"
    time_s: float
    compute_s: float
    collective_s: float


def choose_layer_sharding(batch_tokens: int, d_in: int, d_out: int,
                          data_axis: int, model_axis: int,
                          in_bytes: int = 2,
                          gpu: hwmodel.GPUSpec = hwmodel.H100,
                          link: hwmodel.LinkSpec = hwmodel.H100_NVLINK4
                          ) -> List[ShardingChoice]:
    """The standard layouts of out = x @ W ranked by modelled step time:

    * dp: the batch sharded over the data axis, W replicated;
    * tp_col: W split by columns, the output sharded (its gather is
      charged here);
    * tp_row: W split by rows, the partial outputs all-reduced."""
    from repro_torch.core import interconnect

    chips = data_axis * model_axis
    flops = 2.0 * batch_tokens * d_in * d_out
    peak = peak_flops(in_bytes, gpu)
    out: List[ShardingChoice] = []

    def add(name, shard_factor, coll_kind, coll_payload, axis):
        comp = flops / (shard_factor * peak)
        coll = interconnect.collective_time(coll_kind, coll_payload, axis,
                                            link).time_s \
            if coll_payload else 0.0
        out.append(ShardingChoice(name, comp + coll, comp, coll))

    tokens_local = batch_tokens / data_axis
    add("dp", data_axis, None, 0, 1)
    add("tp_col", chips, "all_gather",
        tokens_local * d_out * in_bytes, model_axis)
    add("tp_row", chips, "all_reduce",
        tokens_local * d_out * in_bytes, model_axis)
    out.sort(key=lambda c: c.time_s)
    return out
