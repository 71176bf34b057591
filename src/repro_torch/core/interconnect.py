"""Interconnect models (port of ``repro/core/interconnect.py``): the
paper's ch. 5 links and the alpha-beta cost of a collective over a mesh
axis, priced on the H100's NVLink (``hwmodel.H100_NVLINK4``) where the
reference prices TPU ICI.

alpha-beta: time(bytes) = hops x per-hop latency + bytes / rate. A ring
over n ranks moves 2 (n - 1) / n of the payload a rank for an all-reduce
and (n - 1) / n for an all-gather or reduce-scatter; the roofline terms
and the collective benchmarks (``core.collectives``) use the same
factors. The reference's inter-pod (DCN) rate has no counterpart: the
port's records describe one host.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from repro_torch.core import hwmodel


@dataclasses.dataclass(frozen=True)
class CollectiveCost:
    bytes_on_wire: float       # a rank, one direction
    time_s: float
    alpha_s: float
    beta_s: float


def _ring_factor(kind: str, n: int) -> float:
    """Payload multiplier a rank for ring algorithms over n ranks. A
    broadcast (a chain from the root) hands each rank the payload once."""
    if n <= 1:
        return 0.0
    if kind == "all_reduce":
        return 2.0 * (n - 1) / n          # reduce-scatter + all-gather
    if kind in ("all_gather", "reduce_scatter"):
        return (n - 1) / n
    if kind == "all_to_all":
        return (n - 1) / n
    if kind in ("collective_permute", "broadcast"):
        return 1.0
    raise ValueError(kind)


def collective_time(kind: str, payload_bytes: float, axis_size: int,
                    link: hwmodel.LinkSpec = hwmodel.H100_NVLINK4,
                    links: Optional[int] = None) -> CollectiveCost:
    """alpha-beta time of one collective over a mesh axis.

    ``payload_bytes`` is the whole logical tensor. ``links`` is how many
    of ``link`` serve the axis (default: all the device has, ``link.links``:
    on an NVSwitch host each of the H100's 18 links reaches every peer)."""
    links = links or link.links
    beta = link.unidir_gbs * 1e9 * links
    n = max(axis_size, 1)
    factor = _ring_factor(kind, axis_size)
    # A rank's wire bytes over the logical payload P:
    #   all-gather / reduce-scatter: P (n-1)/n     all-reduce: 2 P (n-1)/n
    #   all-to-all: P (n-1)/n^2                    permute: P/n (one shard)
    #   broadcast: P
    if kind == "all_to_all":
        per_chip = payload_bytes * factor / n
    elif kind == "collective_permute":
        per_chip = payload_bytes / n
    else:
        per_chip = payload_bytes * factor
    hops = axis_size - 1 if axis_size > 1 else 0
    alpha = hops * link.latency_us * 1e-6
    t = alpha + per_chip / beta
    return CollectiveCost(bytes_on_wire=per_chip, time_s=t,
                          alpha_s=alpha, beta_s=per_chip / beta)


def link_comparison() -> Dict[str, Tuple[float, float]]:
    """The paper's Table 5.1 rows and the H100's NVLink for context:
    name -> (GB/s a link, one direction; latency us)."""
    out = {name: (l.unidir_gbs, l.latency_us)
           for name, l in hwmodel.LINKS.items()}
    nv = hwmodel.H100_NVLINK4
    out[nv.name] = (nv.unidir_gbs, nv.latency_us)
    return out


def measured_vs_theoretical() -> Dict[str, float]:
    """Measured over theoretical rate of each of the paper's links."""
    out = {}
    for name, l in hwmodel.LINKS.items():
        if l.theoretical_gbs:
            out[name] = l.unidir_gbs / l.theoretical_gbs
    return out
