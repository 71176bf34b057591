"""Warp-scheduler model — paper §2.2, Table 2.1.

A copy of ``repro/core/scheduler.py``.

The Volta SM is split into four processing blocks; a warp is pinned to block
``warp_id % 4``. The paper proves the mapping by running FFMA streams on warp
pairs: co-resident pairs (same block) achieve ~42 GFLOPS, split pairs ~66.

Model: each warp sustains an empirical issue rate of ``R_W`` FFMA
instructions/cycle (from the paper's 66.04 GFLOPS for two independent warps
at 1380 MHz: 66.04e9 / 1.38e9 / 64 flops / 2 warps = 0.374); each processing
block's FP32 pipe executes one 32-lane FFMA every 2 cycles (16 FP32 units),
capping co-resident warps at 0.5 instructions/cycle combined.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

FLOPS_PER_INSTR = 64            # 32 lanes x fused multiply-add
R_W = 0.374                     # per-warp sustained issue rate (instr/cycle)
PIPE_RATE = 0.5                 # per-block FP32 pipe (instr/cycle)
N_BLOCKS = 4


def scheduler_id(warp_id: int) -> int:
    """Paper §2.2: scheduler_id = warp_id % 4."""
    return warp_id % N_BLOCKS


def pair_throughput_gflops(warp_a: int, warp_b: int,
                           clock_mhz: float = 1380.0) -> float:
    """Aggregate FFMA throughput of two active warps (Table 2.1)."""
    per_block: Dict[int, float] = {}
    for w in (warp_a, warp_b):
        blk = scheduler_id(w)
        per_block[blk] = per_block.get(blk, 0.0) + R_W
    instr_rate = sum(min(r, PIPE_RATE) for r in per_block.values())
    return instr_rate * FLOPS_PER_INSTR * clock_mhz * 1e6 / 1e9


def table_2_1(clock_mhz: float = 1380.0) -> Dict[Tuple[int, int], float]:
    """Reproduce Table 2.1: warp A in 0..3, warp B in 4..7."""
    return {(a, b): pair_throughput_gflops(a, b, clock_mhz)
            for a in range(4) for b in range(4, 8)}


def min_threads_to_saturate() -> int:
    """Paper §2.2 conclusion: at least 128 threads (one warp per processing
    block) are required to engage every FP32 pipe."""
    return N_BLOCKS * 32


# Paper Table 2.1 measured values (GFLOPS), for benchmark comparison.
PAPER_TABLE_2_1 = {
    (0, 4): 42.27, (1, 4): 66.05, (2, 4): 66.04, (3, 4): 65.29,
    (0, 5): 66.05, (1, 5): 41.98, (2, 5): 66.04, (3, 5): 66.04,
    (0, 6): 66.02, (1, 6): 66.04, (2, 6): 42.06, (3, 6): 66.04,
    (0, 7): 66.04, (1, 7): 66.04, (2, 7): 66.02, (3, 7): 42.08,
}
