"""AdamW with global-norm clipping, as plain functions on trees of
tensors (port of ``repro/optim/adamw.py``; not ``torch.optim.AdamW``, so
the state is the reference's and a checkpoint stores it leaf by leaf).

State: ``{"m", "v"}`` fp32 trees mirroring the parameters and an int32
``count``. Bias correction from ``count``, weight decay on every leaf, all
arithmetic in fp32. ``adamw_update`` updates the parameters and moments
**in place** (the reference returns new trees from a donated state).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

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


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(leaf.float()))
                          for leaf in tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled so their global norm is at most ``max_norm``, the
    norm before clipping)."""
    norm = global_norm(grads)
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
