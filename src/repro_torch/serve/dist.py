"""Tensor-parallel paged serving over ``torch.distributed`` (port of
``repro/serve/dist.py``): the K/V page pool sharded by pages, and the
collectives the sharded layers run.

The pools (``models.transformer.init_paged_caches``) are sharded over one
mesh axis with **pages as the shard unit**: global page ``p`` lives on
rank ``p // block`` at local page ``p % block``, the (device, local page)
pair ``serve.paged.PageAllocator(n_devices=...)`` hands out. Slots are
not the shard unit, so one slot's table can span ranks. Each rank holds
every kv head of its pages (``kv_pages`` takes the mesh axis, so the
pool's kv heads replicate).

* ``scatter_pages``: write the new K/V rows through the table. Each rank
  keeps the rows whose pages it owns and drops the rest: ownership is a
  partition, so every row lands once, with no communication.
* ``gather_pages``: the page-table walk. Each rank gathers the rows it
  owns into the slot-contiguous view, zeros elsewhere, and one
  ``all_reduce(SUM)`` assembles the view on every rank. Exactly one rank
  contributes each row, so the sum is exact in every dtype.

Only ``broadcast`` and ``all_reduce`` are used (gloo runs those two on
CUDA tensors): a gather is an ``all_reduce`` of a zero-padded tensor,
exact for the same reason. ``broadcast`` hands the first rank's drafts
to every rank once a speculative tick (``ServingEngine``), so that the
ranks verify the same tokens whatever their draft sources propose. ``all_reduce`` itself (the row-parallel sums
of ``wo`` and ``w_down``) reorders fp32 additions against one rank.

The engine's host state (allocator, tables, positions) is the same on
every rank and mesh-blind; the layers reach these helpers when the
ambient ruleset (``dist.sharding.use_ruleset``) has a mesh whose
``kv_pages`` axis is larger than 1 (``active_pool_mesh``).
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.dist import sharding
from repro_torch.serve import paged

# Logical name of the pool's page axis.
POOL_RULE = "kv_pages"


def serve_ruleset(mesh, rules: Optional[dict] = None) -> sharding.Ruleset:
    """The serving engine's ruleset: tensor-parallel weights (no FSDP: no
    gather of weights on the decode path) and the sharded page pool."""
    return sharding.Ruleset(mesh=mesh, rules=dict(rules or {}), fsdp=False)


def active_pool_mesh() -> Optional[Tuple[Any, str]]:
    """(mesh, axis) when the ambient ruleset shards the page pool: a real
    mesh (one with ``index`` and ``group``, not a test's stub) whose
    ``kv_pages`` axis is larger than 1; None otherwise, which keeps every
    one-rank path as it is."""
    rs = sharding.current_ruleset()
    if rs is None or not hasattr(rs.mesh, "group"):
        return None
    target = rs._rule(POOL_RULE)
    if target is None:
        return None
    axis = target if isinstance(target, str) else tuple(target)[0]
    if int(dict(rs.mesh.shape).get(axis, 1)) <= 1:
        return None
    return rs.mesh, axis


def sharded(name: str, size: int) -> Optional[Tuple[Any, str]]:
    """(mesh, axis) when the ambient serving ruleset shards a dim named
    ``name`` of global ``size`` (the rule that placed the weights), else
    None. Outside a pool mesh it is None."""
    active = active_pool_mesh()
    if active is None:
        return None
    axis = sharding.current_ruleset().sharded(name, size)
    return None if axis is None else (active[0], axis)


def active_mesh():
    """The ambient serving ruleset's mesh where it is a real one (with
    ``index`` and ``group``) of more than one rank, whatever its axes:
    the contiguous caches' mesh path (``models.layers``), which a data
    axis alone (the batch's slots, a cache's rows) also takes. None
    otherwise."""
    rs = sharding.current_ruleset()
    if rs is None or not hasattr(rs.mesh, "group"):
        return None
    if all(int(n) == 1 for n in dict(rs.mesh.shape).values()):
        return None
    return rs.mesh


class Split:
    """The serving mesh's side of a layer split over a model axis, with
    the interface of a train step's ``train.dist.TrainMesh`` that the
    split layers read (``ruleset``, ``mesh``, ``copy``, ``reduce``,
    ``all_sum``): serving runs no backward, so ``copy`` is the identity
    and ``reduce`` and ``all_sum`` are one ``all_reduce``."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.ruleset = sharding.current_ruleset()

    def copy(self, x, axis: str):
        return x

    def reduce(self, x, axis: str):
        return all_reduce(x.contiguous(), self.mesh, axis)

    all_sum = reduce


def split(name: str, size: int) -> Optional[Tuple[Split, str]]:
    """(``Split``, axis) where the ambient serving ruleset shards a dim
    named ``name`` of global ``size`` over a pool mesh's axis, else
    None (``sharded``)."""
    tp = sharded(name, size)
    return None if tp is None else (Split(tp[0]), tp[1])


def all_reduce(x: torch.Tensor, mesh, axis: str,
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    """Reduce ``x`` (a sum unless ``op`` says otherwise) over ``axis``
    in place on every rank; returns it."""
    dist.all_reduce(x, op=op, group=mesh.group(axis))
    return x


def broadcast(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``x`` as the first rank of this rank's ``axis`` line holds it, on
    every rank of the line, in place; returns it."""
    group = mesh.group(axis)
    src = 0 if group is None else dist.get_global_rank(group, 0)
    dist.broadcast(x, src=src, group=group)
    return x


def all_gather_dim(x: torch.Tensor, dim: int, mesh, axis: str
                   ) -> torch.Tensor:
    """The blocks of ``dim`` that the ranks of ``axis`` hold, joined in
    rank order on every rank: this rank's block placed in zeros and
    summed (``all_reduce``), exact since one rank contributes each
    element (``sharding.gather_leaf`` of the one sharded dim)."""
    return sharding.gather_leaf(x, (None,) * (dim % x.dim()) + (axis,),
                                mesh)


def shard_params(params, mesh, ruleset: sharding.Ruleset):
    """This rank's shard of the full ``params`` tree
    (``dist.sharding.shard_tree``: each leaf cut by the spec its name
    resolves to under ``ruleset``)."""
    return sharding.shard_tree(params, mesh, ruleset)


def shard_caches(caches: List[dict], mesh, axis: str = "model"
                 ) -> List[dict]:
    """Paged caches placed on the mesh: each rank keeps its block of
    ``kp``/``vp`` pages (``n_pages`` must divide the axis), the page table
    and write positions whole (they are the same on every rank)."""
    n = int(mesh.shape[axis])
    out = []
    for c in caches:
        if "kp" not in c:
            out.append(c)
            continue
        if c["kp"].shape[0] % n:
            raise ValueError(f"{c['kp'].shape[0]} pages do not divide "
                             f"{axis}={n}")
        block = c["kp"].shape[0] // n
        i = mesh.index(axis)
        out.append(dict(c, kp=c["kp"][i * block:(i + 1) * block].clone(),
                        vp=c["vp"][i * block:(i + 1) * block].clone()))
    return out


def _owned(page: torch.Tensor, block: int, mesh, axis: str):
    local = page.long() - mesh.index(axis) * block
    return local, (local >= 0) & (local < block)


def scatter_pages(kp, vp, k, v, page, row, mesh, axis: str = "model",
                  src: Optional[torch.Tensor] = None):
    """Write rows (b, s) through the global table into this rank's block
    of the pool, in place, dropping the rows of pages it does not own.
    kp/vp: (block, page_size, kvh, hd) local; k/v: (b, s, kvh, hd) every
    kv head; page/row: (b, s) global page id and in-page row; src: the
    write whose values each one carries (``serve.paged.last_writers``
    over the whole pool, computed here where not given), as
    ``serve.paged.write_rows``."""
    if src is None:
        src = paged.last_writers(page, row, kp.shape[1], kp.shape[0]
                                 * kp.shape[1] * int(mesh.shape[axis]))
    k = k.reshape(-1, *k.shape[2:])[src]
    v = v.reshape(-1, *v.shape[2:])[src]
    local, owned = _owned(page.reshape(-1), kp.shape[0], mesh, axis)
    lp, rw = local[owned], row.reshape(-1)[owned]
    kp[lp, rw] = k[owned].to(kp.dtype)
    vp[lp, rw] = v[owned].to(vp.dtype)
    return kp, vp


def gather_pages(kp, vp, pages, mesh, axis: str = "model"):
    """The page-table walk over the sharded pool: the contiguous
    (b, max_pages * page_size, kvh, hd) view on every rank. Each rank
    places the pages it owns and zeros, and one ``all_reduce`` a tensor
    assembles the view (exact). Rows behind the null page are whatever
    rank 0's page 0 holds, masked by the caller's lengths as in the
    one-rank walk (``serve.paged.gather_kv``)."""
    b, max_pages = pages.shape
    local, owned = _owned(pages, kp.shape[0], mesh, axis)
    lp = torch.where(owned, local, torch.zeros_like(local))
    m = owned[..., None, None, None]
    out = []
    for pool in (kp, vp):
        view = torch.where(m, pool[lp], torch.zeros((), dtype=pool.dtype,
                                                   device=pool.device))
        all_reduce(view, mesh, axis)
        out.append(view.reshape(b, max_pages * pool.shape[1],
                                *pool.shape[2:]))
    return out[0], out[1]


def copy_page(caches: List[dict], old: int, new: int, mesh,
              axis: str = "model") -> None:
    """Copy-on-write across the sharded pool: global page ``old``'s rows
    into page ``new`` in every layer. The owner of ``old`` contributes
    the page, the others zeros, one ``all_reduce`` a layer hands it to
    every rank (exact), and the owner of ``new`` writes it."""
    for c in caches:
        block = c["kp"].shape[0]
        for key in ("kp", "vp"):
            pool = c[key]
            page = torch.zeros_like(pool[0])
            if old // block == mesh.index(axis):
                page.copy_(pool[old % block])
            all_reduce(page, mesh, axis)
            if new // block == mesh.index(axis):
                pool[new % block].copy_(page)
