"""AdamW with global-norm clipping, as plain functions on trees of
tensors (port of ``repro/optim/adamw.py``; not ``torch.optim.AdamW``, so
the state is the reference's and a checkpoint stores it leaf by leaf).

State: ``{"m", "v"}`` fp32 trees mirroring the parameters and an int32
``count``. Bias correction from ``count``, weight decay on every leaf, all
arithmetic in fp32. ``adamw_update`` updates the parameters and moments
**in place** (the reference returns new trees from a donated state). On a
mesh every leaf is a shard and AdamW, being elementwise, runs on the
shards; only the global norm sums over ranks.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1


def adamw_init(params) -> dict:
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
    device = tree_leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree, leaf_axes: Optional[Sequence[tuple]] = None,
                all_reduce: Optional[Callable] = None) -> torch.Tensor:
    """The L2 norm over every leaf. For a tree of shards on a mesh,
    ``leaf_axes`` names the axes each leaf (in ``tree_leaves`` order) is
    sharded on and ``all_reduce(x, axes)`` sums over them: each group of
    leaves sharded alike sums its squares over its axes, and a leaf
    replicated on an axis counts its copy once."""
    squares = [torch.sum(torch.square(leaf.float()))
               for leaf in tree_leaves(tree)]
    if leaf_axes is None:
        return torch.sqrt(sum(squares))
    groups: Dict[tuple, torch.Tensor] = {}
    for sq, axes in zip(squares, leaf_axes):
        groups[axes] = groups[axes] + sq if axes in groups else sq
    return torch.sqrt(sum(all_reduce(v.clone(), axes) if axes else v
                          for axes, v in groups.items()))


def clip_by_global_norm(grads, max_norm: float,
                        leaf_axes: Optional[Sequence[tuple]] = None,
                        all_reduce: Optional[Callable] = None):
    """(grads scaled so their global norm is at most ``max_norm``, the
    norm before clipping); ``leaf_axes``/``all_reduce`` as
    ``global_norm``'s."""
    norm = global_norm(grads, leaf_axes, all_reduce)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), norm


@torch.no_grad()
def adamw_update(grads, state: dict, params, lr,
                 cfg: AdamWConfig = AdamWConfig()) -> Tuple[Any, dict]:
    """One AdamW step at learning rate ``lr`` (a 0-d fp32 tensor or a
    float). Returns the parameters (the same tensors, updated) and the new
    state (the same moment tensors, updated, and the advanced count)."""
    count = state["count"] + 1
    c = count.float()
    b1c = 1.0 - torch.tensor(cfg.b1, device=c.device) ** c
    b2c = 1.0 - torch.tensor(cfg.b2, device=c.device) ** c
    for g, m, v, p in zip(tree_leaves(grads), tree_leaves(state["m"]),
                          tree_leaves(state["v"]), tree_leaves(params)):
        g = g.float()
        m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
        v.copy_(cfg.b2 * v + (1 - cfg.b2) * torch.square(g))
        step = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps) \
            + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * step)
    return params, {"m": state["m"], "v": state["v"], "count": count}
