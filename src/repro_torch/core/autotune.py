"""Microbenchmark-informed GEMM tiling on the H100 (the paper's Ch.1 thesis).

The paper's demonstration is that measured microarchitectural parameters
let a human beat the compiler's schedule. Here the card's published limits
(``hwmodel.H100``) drive an analytical choice among the tiles that the
blocked GEMM kernel (``kernels/csrc/gemm.cu``, ``kernels.gemm.TILES``)
instantiates. Port of the GEMM section of ``repro/core/autotune.py``,
priced for the kernel's own engine:

* a candidate is an instantiated tile whose double-buffered input tiles
  fit one block's shared memory (the reference's VMEM budget);
* the reference's MXU efficiency becomes the tile efficiency: the useful
  share of the padded (m, k, n) that the tiles cover, times the wave
  quantisation of ``ceil(tiles / 132)`` waves of one tile per SM, at the
  CUDA cores' fp32 FFMA rate (the kernel multiplies in fp32 in both input
  types);
* the traffic formula is the reference's C-stationary one, unchanged: with
  (bm, bk, bn) tiles A is streamed n/bn times, B m/bm times and C once.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

from repro_torch.core import hwmodel
from repro_torch.kernels.gemm import TILES

SMEM_ELEM_BYTES = 4             # the kernel stages both inputs as fp32


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

    def smem_bytes(self) -> int:
        # Double-buffered input tiles, fp32 in shared memory whatever the
        # input type; the accumulator lives in registers.
        return 2 * (self.bm * self.bk + self.bk * self.bn) * SMEM_ELEM_BYTES


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def tile_efficiency(p: GemmProblem, c: GemmConfig,
                    gpu: hwmodel.GPUSpec = hwmodel.H100) -> float:
    """Useful share of the FFMA issue a tiling buys: the problem over its
    padding to whole tiles in m, k and n, times the filled share of the
    last wave of ``ceil(tiles / sms)`` (one output tile per SM a wave)."""
    pm, pk, pn = (_ceil_div(d, b) * b for d, b in ((p.m, c.bm), (p.k, c.bk),
                                                   (p.n, c.bn)))
    tiles = _ceil_div(p.m, c.bm) * _ceil_div(p.n, c.bn)
    waves = _ceil_div(tiles, gpu.sms)
    return (p.m * p.k * p.n) / (pm * pk * pn) * tiles / (waves * gpu.sms)


def gemm_cost(p: GemmProblem, c: GemmConfig,
              gpu: hwmodel.GPUSpec = hwmodel.H100) -> Tuple[float, dict]:
    """Modeled execution time (seconds) of the blocked GEMM, plus terms."""
    flops = 2.0 * p.m * p.k * p.n
    eff = tile_efficiency(p, c, gpu)
    compute_s = flops / (gpu.peak_fp32_flops * eff)
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


def candidate_blocks(gpu: hwmodel.GPUSpec = hwmodel.H100) -> List[GemmConfig]:
    """The kernel's instantiated tiles that fit one block's shared memory."""
    return [c for c in (GemmConfig(*t) for t in TILES)
            if c.smem_bytes() <= gpu.smem_per_block]


def choose_gemm_block(p: GemmProblem,
                      gpu: hwmodel.GPUSpec = hwmodel.H100
                      ) -> Tuple[GemmConfig, dict]:
    """Pick the minimum-modeled-time tile (the autotuner's decision)."""
    best, best_t, best_terms = None, float("inf"), None
    for c in candidate_blocks(gpu):
        t, terms = gemm_cost(p, c, gpu)
        if t < best_t:
            best, best_t, best_terms = c, t, terms
    return best, dict(best_terms, time_s=best_t)


NAIVE_BLOCK = GemmConfig(*min(TILES))


def tuning_gain(p: GemmProblem,
                gpu: hwmodel.GPUSpec = hwmodel.H100) -> dict:
    """Naive-vs-tuned comparison — the Ch.1 '+15.4%' analogue, reported by
    ``launch/autotune_gemm.py`` beside the kernel's measured times."""
    t_naive, naive_terms = gemm_cost(p, NAIVE_BLOCK, gpu)
    cfg, terms = choose_gemm_block(p, gpu)
    return {
        "naive": {"config": dataclasses.astuple(NAIVE_BLOCK), **naive_terms,
                  "time_s": t_naive},
        "tuned": {"config": dataclasses.astuple(cfg), **terms},
        "speedup": t_naive / terms["time_s"],
    }
