"""Training over ranks: the collectives that XLA's GSPMD inserts into the
reference's sharded train step, written out and made differentiable.

The reference trains on a mesh by installing a ``Ruleset`` and letting
``jax.jit`` place the batch over ``("pod", "data")`` and each weight by
``param_spec`` (heads, mlp and vocab over ``"model"``; large leaves also
over ``"data"`` under FSDP); GSPMD inserts every gather and reduction,
and the step equals the single-device one. Here a ``TrainMesh`` (the
step's ruleset, and the axes its batch is split over) is installed with
``use_mesh`` while the step's loss runs, and the layers read it through
``sharded`` (``models.layers``, ``models.moe``, ``models.mamba``,
``train.steps``). It is
training's own switch: the serving layers read
``serve.dist.active_pool_mesh`` instead, which it leaves unset.

The collectives, each an ``autograd.Function`` over a mesh axis:

* ``copy``: identity forward, ``all_reduce`` backward: the input of a
  column-parallel region (q/k/v, gate/up, the unembedding), whose ranks
  each return a part of its gradient; and a weight replicated over the
  axis but used inside the region (``q_norm``, or ``wk``/``wv`` where
  the q heads shard and the kv heads do not), whose gradient is then a
  partial sum on each rank.
* ``reduce``: ``all_reduce`` forward, identity backward: the output of a
  row-parallel product (``wo``, ``w_down``), the vocab-sharded
  embedding, and the vocab-sharded loss's sums.
* ``gather``: FSDP's exact gather of a leaf's ``"data"`` blocks forward
  (an ``all_reduce`` of the block placed in zeros: one rank contributes
  each element), and backward the full gradient summed over ``"data"``,
  this rank's block kept.
* ``all_sum``: ``all_reduce`` forward and backward: a sum over the axis
  of per-rank parts that every rank then reads in full and differentiates
  in part (the Mamba norm's sum of squares over heads split across the
  ranks: each rank's gradient of the sum is partial, and each part's
  gradient is the whole of it). Neither ``copy`` nor ``reduce`` alone is
  right there.
* ``scale_grad``: identity forward, the gradient times a constant
  backward: a term every rank of a region computes in full but whose
  gradient a summing collective behind it would count once a rank (the
  mixtures' aux loss under an expert-split model axis, ``models.moe``).
* ``batch_mean``: the mean of a per-rank value over the batch's ranks
  forward, identity backward: the mixtures' global mean router
  probability. Each rank then takes the whole gradient of the global aux
  loss through its own tokens, so once the step averages gradients over
  the data ranks, d(aux)/dθ is counted exactly once.

Every collective is an ``all_reduce`` (gloo runs only ``all_reduce`` and
``broadcast`` on CUDA tensors), and ``TrainMesh.traffic`` counts them and
the bytes they carry. ``batch_block`` cuts this rank's rows of a global
batch.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.dist import sharding

BATCH_AXES = ("pod", "data")


@dataclasses.dataclass
class TrainMesh:
    """A train step's view of the mesh: its ``ruleset`` (whose mesh is a
    ``launch.mesh.Mesh``) and ``batch_axes``, the axes this call's batch
    rows are split over (empty where the batch replicates).
    ``traffic`` counts the collectives run through it and their bytes."""

    ruleset: sharding.Ruleset
    batch_axes: Tuple[str, ...] = ()
    traffic: Dict[str, int] = dataclasses.field(
        default_factory=lambda: {"collectives": 0, "bytes": 0})

    @property
    def mesh(self):
        return self.ruleset.mesh

    def size(self, axes: Sequence[str]) -> int:
        return math.prod(self.mesh.shape.get(a, 1) for a in axes)

    def index(self, axes: Sequence[str]) -> int:
        """This rank's block along ``axes`` composed row-major."""
        i = 0
        for a in axes:
            i = i * self.mesh.shape[a] + self.mesh.index(a)
        return i

    @property
    def data_axes(self) -> Tuple[str, ...]:
        """The mesh's batch axes (``pod``, ``data``) larger than 1."""
        return tuple(a for a in BATCH_AXES if self.mesh.shape.get(a, 1) > 1)

    @property
    def model_parallel(self) -> bool:
        return self.mesh.shape.get("model", 1) > 1

    def all_reduce(self, x: torch.Tensor, axes: Sequence[str]
                   ) -> torch.Tensor:
        """Sum ``x`` in place over each of ``axes`` (one ``all_reduce`` an
        axis larger than 1); returns it."""
        for a in axes:
            if self.mesh.shape.get(a, 1) > 1:
                dist.all_reduce(x, op=dist.ReduceOp.SUM,
                                group=self.mesh.group(a))
                self.traffic["collectives"] += 1
                self.traffic["bytes"] += x.numel() * x.element_size()
        return x

    def stack(self, x: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
        """(ranks along ``axes``, *x.shape): every rank's ``x`` in its
        slot, on every rank (zeros placed around this rank's, summed:
        exact)."""
        out = x.new_zeros((self.size(axes),) + tuple(x.shape))
        out[self.index(axes)] = x
        return self.all_reduce(out, axes)

    def all_max(self, x: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
        """The elementwise max of ``x`` over the ranks of ``axes``, exact
        (``stack`` then a max), without a gradient."""
        if self.size(axes) == 1:
            return x.detach()
        return self.stack(x.detach(), axes).amax(dim=0)

    # The differentiable collectives (module docstring).
    def copy(self, x, axis: str):
        return _Copy.apply(x, self, axis)

    def reduce(self, x, axis: str):
        return _Reduce.apply(x, self, axis)

    def gather(self, x, dim: int, axis: str):
        return _Gather.apply(x, self, dim, axis)

    def all_sum(self, x, axis: str):
        return _AllSum.apply(x, self, axis)

    def scale_grad(self, x, factor: float):
        return _ScaleGrad.apply(x, factor)

    def batch_mean(self, x):
        return _BatchMean.apply(x, self, self.batch_axes)


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tm, axis):
        ctx.tm, ctx.axis = tm, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.tm.all_reduce(g.contiguous().clone(), (ctx.axis,)), \
            None, None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tm, axis):
        return tm.all_reduce(x.contiguous().clone(), (axis,))

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _AllSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tm, axis):
        ctx.tm, ctx.axis = tm, axis
        return tm.all_reduce(x.contiguous().clone(), (axis,))

    @staticmethod
    def backward(ctx, g):
        return ctx.tm.all_reduce(g.contiguous().clone(), (ctx.axis,)), \
            None, None


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, factor):
        ctx.factor = factor
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.factor, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tm, dim, axis):
        n, i = tm.mesh.shape[axis], tm.mesh.index(axis)
        size = x.shape[dim]
        ctx.tm, ctx.dim, ctx.axis, ctx.block = tm, dim, axis, (i * size, size)
        shape = list(x.shape)
        shape[dim] = n * size
        out = x.new_zeros(shape)
        out.narrow(dim, i * size, size).copy_(x)
        return tm.all_reduce(out, (axis,))

    @staticmethod
    def backward(ctx, g):
        g = ctx.tm.all_reduce(g.contiguous().clone(), (ctx.axis,))
        return g.narrow(ctx.dim, *ctx.block).contiguous(), None, None, None


class _BatchMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tm, axes):
        return tm.all_reduce(x.contiguous().clone(), axes) / tm.size(axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


# ----------------------------------------------------------------------------
# The switch the layers read (thread-local, re-entrant)
# ----------------------------------------------------------------------------

_ACTIVE = threading.local()


def active() -> Optional[TrainMesh]:
    return getattr(_ACTIVE, "mesh", None)


@contextlib.contextmanager
def use_mesh(tm: Optional[TrainMesh]):
    """Install ``tm`` for the layers of the forward run inside; None
    leaves every layer on its one-rank path."""
    prev = active()
    _ACTIVE.mesh = tm
    try:
        yield tm
    finally:
        _ACTIVE.mesh = prev


def sharded(name: str, size: int) -> Optional[Tuple[TrainMesh, str]]:
    """(the active TrainMesh, axis) when its ruleset shards a dim named
    ``name`` of global ``size`` (the rule that placed the weight, with
    its divisibility fallback), else None; None outside a train step."""
    tm = active()
    if tm is None:
        return None
    axis = tm.ruleset.sharded(name, size)
    return None if axis is None else (tm, axis)


def batch_block(batch: Dict[str, torch.Tensor], ruleset: sharding.Ruleset,
                accum: int = 1) -> Tuple[Dict[str, torch.Tensor],
                                         Tuple[str, ...]]:
    """(this rank's rows of the global ``batch``, the axes they are split
    over). Each of the ``accum`` micro-batches (consecutive blocks of
    rows) is split over ``("pod", "data")`` by ``ruleset.spec``, with its
    divisibility fallback (a micro-batch that does not divide the axes
    replicates over them), and the rank's parts of the micro-batches are
    concatenated in order: the reference slices the global batch, and
    GSPMD then shards each slice."""
    rows = next(iter(batch.values())).shape[0]
    if rows % accum:
        raise ValueError(f"batch {rows} is not a multiple of accum {accum}")
    micro = rows // accum
    axes = ruleset.spec(("batch",), (micro,))[0]
    if axes is None:
        return batch, ()
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    tm = TrainMesh(ruleset)
    n, i = tm.size(axes), tm.index(axes)
    part = micro // n

    def cut(v):
        v = v.reshape((accum, micro) + tuple(v.shape[1:]))
        return v[:, i * part:(i + 1) * part].reshape(
            (accum * part,) + tuple(v.shape[2:]))

    return {k: cut(v) for k, v in batch.items()}, axes
