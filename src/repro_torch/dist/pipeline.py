"""GPipe pipeline parallelism over one mesh axis (port of
``repro/dist/pipeline.py``).

``gpipe(layer, mesh, axis)`` turns a per-stage ``layer(weights, x)`` into
a pipelined function over stage-stacked weights and a leading microbatch
dim: stage i (the rank at index i along ``axis``) holds its own weights,
runs microbatch t - i at tick t, and hands its activation to stage i + 1:
the classic GPipe schedule, with (stages - 1) / (microbatches + stages -
1) of its stage-ticks idle (``bubble_fraction``).

The hand-off is one ``all_reduce`` a tick of a zero-padded (stages,
*activation) stack in which each stage writes its output into its own
slot, exact since one rank contributes each slot: the reference's
``ppermute`` ring, written with the one collective that gloo runs on CUDA
tensors as on CPU tensors (its ``isend``/``irecv`` do not run on CUDA
tensors), so one path serves both devices. A stage skips its bubble
ticks (the reference computes and masks them out), and the last stage's
outputs reach every rank through one more ``all_reduce``, as the
reference's ``psum`` leaves them.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.tree import tree_leaves, tree_map


def bubble_fraction(stages: int, microbatches: int) -> float:
    """Fraction of stage-ticks idle in one GPipe forward sweep."""
    return (stages - 1) / (microbatches + stages - 1)


def gpipe(layer: Callable, mesh, axis: str = "stage") -> Callable:
    """Pipeline ``layer`` over the mesh axis ``axis``.

    Returns ``fn(weights, micro)``: every ``weights`` leaf has a leading
    stage dim equal to the axis size (``ValueError`` otherwise), and
    ``micro`` is (microbatches, *sample_shape); the layer keeps the
    sample shape. The result, on every rank of the axis, equals applying
    the stages in order to every microbatch; the schedule runs
    microbatches + stages - 1 ticks."""
    n_stages = int(mesh.shape[axis])
    group = mesh.group(axis)

    def transform(weights, micro: torch.Tensor) -> torch.Tensor:
        for leaf in tree_leaves(weights):
            if leaf.shape[0] != n_stages:
                raise ValueError(f"stage dim {leaf.shape[0]} != mesh axis "
                                 f"{axis}={n_stages}")
        i = mesh.index(axis)
        w = tree_map(lambda a: a[i], weights)      # this stage's slice
        n_micro = micro.shape[0]
        state = None                               # input from stage i - 1
        out = torch.zeros_like(micro)
        for t in range(n_micro + n_stages - 1):
            m = t - i                              # this stage's microbatch
            hand = micro.new_zeros((n_stages,) + tuple(micro.shape[1:]))
            if 0 <= m < n_micro:
                y = layer(w, micro[m] if i == 0 else state)
                if i == n_stages - 1:
                    out[m] = y
                else:
                    hand[i] = y
            dist.all_reduce(hand, op=dist.ReduceOp.SUM, group=group)
            state = hand[i - 1] if i > 0 else None
        # Only the last stage wrote; the sum hands its outputs to all.
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    return transform
