"""Microbenchmark-informed GEMM tiling on the H100 (the paper's Ch.1 thesis).

The paper's demonstration is that measured microarchitectural parameters
let a human beat the compiler's schedule. Here the card's published limits
(``hwmodel.H100``) drive an analytical choice among the tiles that the
GEMM kernels (``kernels/csrc/gemm.cu``, ``kernels.gemm.TILES``) instantiate
for the problem's input type. Port of the GEMM section of
``repro/core/autotune.py``, priced for each kernel's own engine:

* a candidate is an instantiated tile of the input type whose staged input
  tiles fit one block's shared memory (the reference's VMEM budget): two
  fp32 buffers for the CUDA-core kernel, ``TC_STAGES`` bf16 ones for the
  tensor-core kernel;
* the reference's MXU efficiency becomes the tile efficiency: the useful
  share of the padded (m, k, n) that the tiles cover, times the wave
  quantisation of ``ceil(tiles / 132)`` waves of one tile per SM, at the
  engine's rate: the CUDA cores' fp32 FFMA rate for fp32 inputs, the
  tensor cores' dense bf16 rate for bf16;
* the traffic formula is the reference's C-stationary one, unchanged: with
  (bm, bk, bn) tiles A is streamed n/bn times, B m/bm times and C once.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import torch

from repro_torch.core import hwmodel
from repro_torch.kernels.gemm import TC_STAGES, TILES

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
