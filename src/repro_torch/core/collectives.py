"""Collective benchmarks over a mesh axis (port of
``repro/core/collectives.py``; paper ch. 5).

The paper measures link rates with peer copies; here the unit is the
collective over a process group (``launch.mesh.Mesh``). The reference
reads the wire bytes the compiler scheduled from compiled HLO; the port
runs eagerly, so ``wire_bytes`` is reckoned from the ring factor of the
collective (``interconnect._ring_factor``) and its payload, and the
collective is timed over the group. The time is the group's: on a gloo
group it is the host's path (a device tensor copied to the host, reduced
over local sockets, copied back), not the link the alpha-beta model
prices.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import List, Optional

import torch
import torch.distributed as dist

from repro_torch.core import hwmodel, interconnect

@dataclasses.dataclass
class CollectiveBench:
    kind: str
    payload_bytes: int
    axis: str
    axis_size: int
    wire_bytes: float           # a rank: payload x ring factor
    modeled_bytes: float        # alpha-beta accounting
    modeled_time_s: float
    effective_gbs: float        # payload / modeled time
    measured_time_s: float      # median over the repeats, on this group
    measured_gbs: float         # payload / measured time


def _op(kind: str, x: torch.Tensor, mesh, axis: str):
    """One collective of ``kind`` on ``x`` (this rank's whole payload)
    over ``axis``; returns a callable that runs it."""
    group, n = mesh.group(axis), mesh.shape[axis]
    i = mesh.index(axis)
    peer = (lambda j: j % n) if group is None else \
        (lambda j: dist.get_global_rank(group, j % n))
    if kind == "all_reduce":
        return lambda: dist.all_reduce(x, group=group)
    if kind == "broadcast":
        return lambda: dist.broadcast(x, src=peer(0), group=group)
    if kind == "all_gather":
        parts = list(x.chunk(n))
        return lambda: dist.all_gather(parts, parts[i].clone(), group=group)
    if kind == "reduce_scatter":
        out = torch.empty_like(x.chunk(n)[0])
        return lambda: dist.reduce_scatter(out, list(x.chunk(n)),
                                           group=group)
    if kind == "all_to_all":
        out = torch.empty_like(x)
        return lambda: dist.all_to_all_single(out, x, group=group)
    if kind == "collective_permute":
        out = torch.empty_like(x.chunk(n)[0])
        shard = x.chunk(n)[i].contiguous()

        def permute():
            ops = [dist.P2POp(dist.isend, shard, peer(i + 1), group),
                   dist.P2POp(dist.irecv, out, peer(i - 1), group)]
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return permute
    raise ValueError(kind)


def bench_collective(mesh, kind: str, payload_bytes: int, axis: str,
                     dtype: torch.dtype = torch.bfloat16, device=None,
                     repeats: int = 5,
                     link: hwmodel.LinkSpec = hwmodel.H100_NVLINK4
                     ) -> CollectiveBench:
    """Time one collective of about ``payload_bytes`` (rounded down to a
    multiple of the axis size in elements) over ``mesh``'s ``axis`` and
    account its wire bytes. Every rank of the group must call it with the
    same arguments. ``device`` holds the payload (the CPU by default)."""
    axis_size = mesh.shape[axis]
    itemsize = torch.empty((), dtype=dtype).element_size()
    n_elems = max(axis_size, payload_bytes // itemsize)
    n_elems = (n_elems // axis_size) * axis_size
    x = torch.ones(n_elems, dtype=dtype, device=device)
    run = _op(kind, x, mesh, axis)
    cuda = x.device.type == "cuda"
    run()                                                # warm-up
    times = []
    for _ in range(repeats):
        dist.barrier(group=mesh.group(axis))
        if cuda:
            torch.cuda.synchronize(x.device)
        t0 = time.perf_counter()
        run()
        if cuda:
            torch.cuda.synchronize(x.device)
        times.append(time.perf_counter() - t0)
    measured = statistics.median(times)
    payload = n_elems * itemsize
    cost = interconnect.collective_time(kind, payload, axis_size, link)
    eff = payload / cost.time_s / 1e9 if cost.time_s else 0.0
    return CollectiveBench(
        kind=kind, payload_bytes=payload, axis=axis, axis_size=axis_size,
        wire_bytes=payload * interconnect._ring_factor(kind, axis_size),
        modeled_bytes=cost.bytes_on_wire, modeled_time_s=cost.time_s,
        effective_gbs=eff, measured_time_s=measured,
        measured_gbs=payload / measured / 1e9 if measured else 0.0)


def bandwidth_curve(mesh, kind: str, axis: str,
                    sizes_bytes: Optional[List[int]] = None,
                    dtype: torch.dtype = torch.bfloat16, device=None,
                    repeats: int = 5) -> List[CollectiveBench]:
    """Rate against message size (the ch. 5 figure's analogue): small
    messages are latency-bound, large ones rate-bound."""
    sizes = sizes_bytes or [2 ** p for p in range(12, 28, 2)]
    return [bench_collective(mesh, kind, s, axis, dtype=dtype,
                             device=device, repeats=repeats)
            for s in sizes]
