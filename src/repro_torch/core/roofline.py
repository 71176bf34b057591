"""Three-term roofline of a dry-run cell (port of
``repro/core/roofline.py``), priced on the H100:

    compute term    = FLOPs / peak bf16 FLOP/s
    memory term     = bytes / HBM rate
    collective term = collective bytes / (link rate x links)

The quantities are one rank's, for one step, read from its op trace
(``core.op_analysis``: ``terms_from_trace`` replaces the reference's
``terms_from_compiled``): the FLOPs of every op, the operand and result
bytes of every op that moves data, and the payload of every collective.
The hardware is ``hwmodel.H100`` (989e12 bf16 FLOP/s dense, 3.35e12 B/s)
and its NVLink, ``hwmodel.H100_NVLINK4`` (25 GB/s a link each way, 18
links), where the reference uses ``DEFAULT_TPU``'s. The collective term
divides the payload by the link rate times the links, as the reference's
formula does: the serial upper bound of a ring, with no ring factor.

The port fuses nothing, so its bytes are those of an unfused program:
every op reads its inputs and writes its outputs through HBM.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict

from repro_torch.core import hwmodel, op_analysis

_GPU = hwmodel.H100
_LINK = hwmodel.H100_NVLINK4


@dataclasses.dataclass
class RooflineTerms:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float            # a rank, a step (the trace's FLOPs)
    hlo_bytes: float            # a rank, a step
    collective_bytes: float     # a rank, a step (payload bytes)
    model_flops: float          # 6 N D (or serving's), the whole step
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: float = 0.0
    peak_flops: float = _GPU.peak_bf16_flops

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Serial upper bound (no overlap)."""
        return self.compute_s + self.memory_s + self.collective_s

    @property
    def step_time_overlapped_s(self) -> float:
        """Perfect-overlap lower bound: the max of the three engines."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def roofline_fraction(self) -> float:
        """Useful-compute fraction of the overlapped bound."""
        if self.step_time_overlapped_s == 0:
            return 0.0
        useful_s = (self.model_flops / self.chips) / self.peak_flops
        return useful_s / self.step_time_overlapped_s

    @property
    def mfu(self) -> float:
        """Model-FLOPs utilization against the serial step-time bound."""
        if self.step_time_s == 0:
            return 0.0
        useful_s = (self.model_flops / self.chips) / self.peak_flops
        return useful_s / self.step_time_s

    @property
    def flops_efficiency(self) -> float:
        """MODEL_FLOPS over the traced FLOPs of every rank: how much of
        the computed work is useful (remat and replicated work show as
        less than 1)."""
        total = self.hlo_flops * self.chips
        return self.model_flops / total if total else 0.0

    def to_dict(self) -> Dict:
        d = dataclasses.asdict(self)
        d.update(dominant=self.dominant,
                 step_time_s=self.step_time_s,
                 step_time_overlapped_s=self.step_time_overlapped_s,
                 roofline_fraction=self.roofline_fraction,
                 mfu=self.mfu,
                 flops_efficiency=self.flops_efficiency)
        return d


def compute_terms(arch: str, shape: str, mesh_name: str, chips: int,
                  hlo_flops: float, hlo_bytes: float,
                  collective_bytes: float, model_flops: float,
                  gpu: hwmodel.GPUSpec = _GPU,
                  link: hwmodel.LinkSpec = _LINK) -> RooflineTerms:
    """The three terms (seconds) from one rank's quantities. ``gpu`` is
    anything with ``peak_bf16_flops`` and ``hbm_bandwidth``; the
    collectives ride ``link.links`` of ``link``."""
    t = RooflineTerms(arch=arch, shape=shape, mesh=mesh_name, chips=chips,
                      hlo_flops=hlo_flops, hlo_bytes=hlo_bytes,
                      collective_bytes=collective_bytes,
                      model_flops=model_flops,
                      peak_flops=gpu.peak_bf16_flops)
    t.compute_s = hlo_flops / gpu.peak_bf16_flops
    t.memory_s = hlo_bytes / gpu.hbm_bandwidth
    t.collective_s = collective_bytes / (link.unidir_gbs * 1e9 * link.links)
    return t


def collective_matmul_terms(m: int, k: int, n: int, axis_size: int,
                            in_bytes: int = 2,
                            gpu: hwmodel.GPUSpec = _GPU,
                            link: hwmodel.LinkSpec = _LINK
                            ) -> Dict[str, RooflineTerms]:
    """The lowerings of one tensor-parallel matmul ``(m, k) @ (k, n)``
    with the contraction dim split over ``axis_size`` ranks, as roofline
    cells (the reference's variants): ``all_gather`` (gather x, then the
    GEMM: its honest time is the serial ``step_time_s``), ``ag_ring``
    (the same wire bytes hidden under the GEMM steps:
    ``step_time_overlapped_s``), ``rs_ring`` (partial sums circulated,
    the output left sharded) and ``all_reduce`` (row-parallel x @ w then
    a sum: twice a reduce-scatter's wire bytes)."""
    from repro_torch.core import interconnect

    f = axis_size
    flops = 2.0 * m * k * n / f
    x_b, w_b = m * k * in_bytes / f, k * n * in_bytes
    out_full, out_shard = m * n * in_bytes, m * n * in_bytes / f

    def wire(kind, payload):
        return interconnect.collective_time(kind, payload, f,
                                            link).bytes_on_wire

    wires = {"all_gather": wire("all_gather", m * k * in_bytes),
             "ag_ring": wire("all_gather", m * k * in_bytes),
             "rs_ring": wire("reduce_scatter", m * n * in_bytes),
             "all_reduce": wire("all_reduce", m * n * in_bytes)}
    resident = {"all_gather": out_full, "ag_ring": out_full,
                "rs_ring": out_shard, "all_reduce": out_full}
    return {variant: compute_terms(
        arch=f"matmul_{variant}", shape=f"{m}x{k}x{n}", mesh_name=f"tp{f}",
        chips=f, hlo_flops=flops, hlo_bytes=x_b + w_b + resident[variant],
        collective_bytes=coll, model_flops=2.0 * m * k * n, gpu=gpu,
        link=link) for variant, coll in wires.items()}


def terms_from_trace(arch: str, shape: str, mesh_name: str, chips: int,
                     trace: op_analysis.OpTrace,
                     model_flops: float) -> RooflineTerms:
    """The terms of one rank's traced step (``core.op_analysis``)."""
    return compute_terms(arch, shape, mesh_name, chips,
                         op_analysis.trace_flops(trace),
                         op_analysis.trace_bytes(trace),
                         op_analysis.trace_collective_bytes(trace),
                         model_flops)


def format_table(rows) -> str:
    """A Markdown table of roofline rows."""
    hdr = ("| arch | shape | mesh | compute_s | memory_s | collective_s | "
           "dominant | MODEL/traced flops | roofline frac |")
    sep = "|" + "---|" * 9
    lines = [hdr, sep]
    for t in rows:
        lines.append(
            f"| {t.arch} | {t.shape} | {t.mesh} | {t.compute_s:.3e} | "
            f"{t.memory_s:.3e} | {t.collective_s:.3e} | {t.dominant} | "
            f"{t.flops_efficiency:.2f} | {t.roofline_fraction:.3f} |")
    return "\n".join(lines)


def save_rows(rows, path: str):
    with open(path, "w") as f:
        json.dump([t.to_dict() for t in rows], f, indent=1)


def load_rows(path: str):
    with open(path) as f:
        data = json.load(f)
    out = []
    for d in data:
        t = RooflineTerms(
            arch=d["arch"], shape=d["shape"], mesh=d["mesh"],
            chips=d["chips"], hlo_flops=d["hlo_flops"],
            hlo_bytes=d["hlo_bytes"],
            collective_bytes=d["collective_bytes"],
            model_flops=d["model_flops"],
            peak_flops=d.get("peak_flops", _GPU.peak_bf16_flops))
        t.compute_s = d["compute_s"]
        t.memory_s = d["memory_s"]
        t.collective_s = d["collective_s"]
        out.append(t)
    return out
