"""Atomic-operation latency/throughput models — paper §4.2, Table 4.2, Fig 4.1.

A copy of ``repro/core/atomics.py``.

Shared-memory atomics serialize under intra-warp contention; the paper's
Table 4.2 shows near-linear growth on Volta/Pascal/Maxwell (hardware atomics)
and explosive growth on Kepler (emulated via lock/unlock). We fit the
published table with a base + slope serialization model and report residuals;
the four Fig 4.1 throughput scenarios are modeled from the same serialization
cost plus L2-line parallelism.

The chapter is model-only here, as in the reference: the fits are of the
published table, not of a measurement.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from repro_torch.core import hwmodel


def fit_serialization(table: Dict[int, Tuple[int, int]], which: int
                      ) -> Tuple[float, float]:
    """Least-squares fit latency(R) = base + slope * R over the published
    contention table. ``which``: 0 = shared, 1 = global."""
    r = np.array(sorted(table))
    y = np.array([table[k][which] for k in sorted(table)], dtype=float)
    a = np.vstack([np.ones_like(r, dtype=float), r]).T
    (base, slope), *_ = np.linalg.lstsq(a, y, rcond=None)
    return float(base), float(slope)


def modeled_latency(spec: hwmodel.PaperGPUSpec, contention: int,
                    space: str = "shared") -> float:
    """Serialization model: base latency + per-extra-thread cost."""
    table = spec.atomic_latency
    if table is None:
        raise ValueError(f"no atomic data for {spec.name}")
    which = 0 if space == "shared" else 1
    base, slope = fit_serialization(table, which)
    return base + slope * contention


def model_residuals(spec: hwmodel.PaperGPUSpec, space: str = "shared"
                    ) -> Dict[int, Tuple[float, float]]:
    """(published, modeled) latency per contention level."""
    which = 0 if space == "shared" else 1
    out = {}
    for r, vals in sorted(spec.atomic_latency.items()):
        out[r] = (float(vals[which]), modeled_latency(spec, r, space))
    return out


def throughput_scenario(spec: hwmodel.PaperGPUSpec, scenario: int,
                        blocks: int = 80, contention: int = 32) -> float:
    """Modeled atomicAdd throughput (ops/cycle, whole chip) for the four
    Fig 4.1 scenarios.

    1: one block, R threads contend on one address, rest spread over a line
    2: like 1 but each group on its own L2 line
    3: many blocks, all threads on one address (global serialization)
    4: many blocks, block-private addresses (no cross-block contention)
    """
    base, slope = fit_serialization(spec.atomic_latency, 1)
    serial_cost = base + slope * contention
    per_block_rate = 1024.0 / serial_cost
    if scenario == 1:
        return per_block_rate
    if scenario == 2:
        return per_block_rate * 2.0        # line-level parallelism recovered
    if scenario == 3:
        return 1024.0 * blocks / (serial_cost * blocks)   # one hot address
    if scenario == 4:
        return per_block_rate * blocks     # scales with SM count
    raise ValueError(scenario)
