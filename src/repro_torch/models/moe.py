"""Mixture-of-experts MLP with token-choice top-k routing (port of
``repro/models/moe.py``).

Two paths with the same math, held to each other and to the reference by
the tests:

* ``dense_mask``: every expert runs on every token, weighted by the
  token's gate (zero where the expert was not chosen). Its work grows
  with ``n_experts``: the small configurations' path.
* ``capacity``: the (token, expert) choices are sorted by expert
  (stably, as ``jnp.argsort``), each takes its rank within its expert,
  and the first ``capacity`` of each expert are copied into an
  (experts, capacity, d) buffer; the experts run as batched matrix
  products over it, and each token sums its k weighted outputs. A choice
  past its expert's capacity is dropped: it contributes nothing.

The expert products are large matrix products outside any kernel of the
reference (its ``einsum``s), so they are ``torch.bmm``/``torch.matmul``.

The capacity path runs inside the engines' captured CUDA graphs, so it
never waits on the host: ``capacity`` is computed in Python from the
call's static token count, the expert counts of the auxiliary loss go
through ``scatter_add_``, and a dropped choice is sent to one extra row of
the buffer (``torch.where``), as the reference does, instead of being
filtered by a boolean mask. Each token's k outputs are gathered back into
(t, k, d) and summed over k, a fixed order, so an eager step and its
graph give the same bits (a scatter-add by ``index_add_`` would use
atomics).

``moe_apply`` returns ``(out, aux)``: ``aux`` is the Switch-style
load-balancing loss, which only training adds (``train.steps.loss_fn``,
weighted by ``aux_weight``).

**Over the data axis** (a train step on a mesh whose batch rows are
split over ranks, ``train.dist``): the reference routes the whole global
batch, so each rank does too. The capacity comes from the global token
count; a choice's rank within its expert follows global token order, so
each rank offsets its local ranks by the per-expert counts of the batch
ranks before it (exact integer sums); the aux loss takes the global
density and the global mean probability (``TrainMesh.batch_mean``).

**Over the model axis** (a train step's, ``train.dist``, or a serving
engine's mesh, ``serve.dist``): every model rank holds every token. Where
the rules split the experts over the axis (``"experts": "model"``), each
rank holds ``n_experts / ranks`` whole experts and their columns of the
router; its router logits are gathered over the axis before the softmax
and the top-k (an exact zero-padded ``all_reduce``), so the routing, the
capacity and the drops are the same on every rank. Each rank fills and
runs only its own experts' rows of the (experts, capacity, d) buffer (or
its own experts, ``dense_mask``), adds their weighted outputs for every
token, and one ``reduce`` over the axis sums the ranks. Where the experts
do not divide the axis, the rules give the axis to their ``mlp`` dim
instead (the divisibility fallback): every rank holds every expert with a
1/ranks slice of its FFN and the whole router, routes alone, and the
partial outputs are summed the same way. In training the token input (and
a whole router) enters the region through ``copy``, since each rank's
gradient of it is partial; the aux loss, which every rank computes whole,
has its gradient scaled by 1/ranks, since the summing collective behind
it (the gather's backward, or ``copy``'s) would otherwise count it once a
rank. A shared expert is a dense MLP and splits as one
(``layers.mlp_apply``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers
from repro_torch.serve import dist as serve_dist
from repro_torch.train import dist as train_dist

Params = Dict[str, object]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_ff: int                   # per-expert hidden dim
    n_experts: int
    top_k: int
    n_shared: int = 0           # shared (always-on) experts
    capacity_factor: float = 1.25
    impl: str = "dense_mask"    # "dense_mask" | "capacity"
    router_dtype: torch.dtype = torch.float32   # logits, softmax, top-k

    def shared_cfg(self) -> layers.MLPConfig:
        return layers.MLPConfig(self.d_model, self.d_ff * self.n_shared,
                                "swiglu")


def capacity(cfg: MoEConfig, tokens: int) -> int:
    """Rows of the buffer each expert gets for a call of ``tokens``
    tokens: ceil(tokens * k / experts * factor), at least 4."""
    return max(math.ceil(tokens * cfg.top_k / cfg.n_experts
                         * cfg.capacity_factor), 4)


def moe_init(generator: torch.Generator, cfg: MoEConfig, device,
             dtype: torch.dtype) -> Params:
    """The reference's distributions (``moe.moe_init``): the router a
    standard normal times 0.02, kept in fp32 (the reference routes in
    fp32); ``expert_gate``/``expert_up`` (e, d, f) times 1/sqrt(e), which
    is ``layers._init``'s default scale 1/sqrt(shape[0]) (a fault of the
    reference, copied so that the card sees its activations: ROADMAP Queue
    3); ``expert_down`` (e, f, d) times 1/sqrt(f); the shared expert a
    SwiGLU MLP of width ``f * n_shared``. The experts are drawn one at a
    time into ``dtype`` tensors, so that no fp32 copy of a whole (e, d, f)
    tensor is made."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts

    def normal(shape, scale):
        w = torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32)
        return (w * scale).to(dtype)

    def experts(shape, scale):
        out = torch.empty((e,) + shape, device=device, dtype=dtype)
        for i in range(e):
            out[i] = normal(shape, scale)
        return out

    p = {
        "router": normal((d, e), 0.02).float(),
        "expert_gate": experts((d, f), 1.0 / math.sqrt(e)),
        "expert_up": experts((d, f), 1.0 / math.sqrt(e)),
        "expert_down": experts((f, d), 1.0 / math.sqrt(f)),
    }
    if cfg.n_shared:
        fs = f * cfg.n_shared
        p["shared"] = {"w_gate": normal((d, fs), 1.0 / math.sqrt(d)),
                       "w_up": normal((d, fs), 1.0 / math.sqrt(d)),
                       "w_down": normal((fs, d), 1.0 / math.sqrt(fs))}
    return p


def _data_split():
    """The train step's mesh when its batch rows are split over ranks
    (routing must then span the ranks), else None."""
    tm = train_dist.active()
    return tm if tm is not None and tm.batch_axes else None


class _ModelSplit:
    """A mixture's model axis: ``experts`` True where the experts are
    split over it (this rank holds experts ``[index * local, (index + 1)
    * local)`` and their router columns), False where their ``mlp`` dim
    is (every expert, a slice of its FFN, the router whole). Its
    collectives are a train step's differentiable ones (``tm``) or a
    serving mesh's (``mesh``)."""

    def __init__(self, experts: bool, axis: str, tm=None, mesh=None):
        self.experts, self.axis, self.tm, self.mesh = experts, axis, tm, mesh
        m = tm.mesh if tm is not None else mesh
        self.ranks, self.index = int(m.shape[axis]), m.index(axis)

    def copy(self, x):
        return x if self.tm is None else self.tm.copy(x, self.axis)

    def reduce(self, x):
        if self.tm is None:
            return serve_dist.all_reduce(x, self.mesh, self.axis)
        return self.tm.reduce(x, self.axis)

    def gather(self, x, dim: int):
        if self.tm is None:
            return serve_dist.all_gather_dim(x, dim, self.mesh, self.axis)
        return self.tm.gather(x, dim, self.axis)

    def once(self, x):
        """A term every rank computes whole, its gradient counted once
        over the ranks by the summing collectives behind it."""
        return x if self.tm is None else self.tm.scale_grad(
            x, 1.0 / self.ranks)


def _local_experts(split: Optional[_ModelSplit],
                   n_experts: int) -> Tuple[int, int]:
    """(first expert this rank runs, experts it runs)."""
    if split is None or not split.experts:
        return 0, n_experts
    n = n_experts // split.ranks
    return split.index * n, n


def _model_split(cfg: MoEConfig) -> Optional[_ModelSplit]:
    """The model axis the active train step or serving mesh splits this
    mixture over (its experts, else their ``mlp`` dim: the rule that
    placed the weights, with its divisibility fallback), or None."""
    for experts, name, size in ((True, "experts", cfg.n_experts),
                                (False, "mlp", cfg.d_ff)):
        train = train_dist.sharded(name, size)
        if train is not None:
            return _ModelSplit(experts, train[1], tm=train[0])
        tp = serve_dist.sharded(name, size)
        if tp is not None:
            return _ModelSplit(experts, tp[1], mesh=tp[0])
    return None


def _counts(ids, n_experts: int):
    """(choices of each expert in the ranks' batch blocks before this
    one's, in the whole batch), int64 (e,): over the data axis through
    one exact ``all_reduce``, else (zeros, this call's counts)."""
    flat = ids.reshape(-1)
    local = torch.zeros(n_experts, dtype=torch.int64,
                        device=ids.device).scatter_add_(
        0, flat, torch.ones_like(flat))
    tm = _data_split()
    if tm is None:
        return torch.zeros_like(local), local
    every = tm.stack(local, tm.batch_axes)            # (ranks, e)
    return every[:tm.index(tm.batch_axes)].sum(0), every.sum(0)


def _global_tokens(t: int) -> int:
    tm = _data_split()
    return t if tm is None else t * tm.size(tm.batch_axes)


def _route(params: Params, cfg: MoEConfig, x,
           split: Optional[_ModelSplit] = None):
    """Router in ``cfg.router_dtype`` -> (weights (t, k) in x's dtype,
    ids (t, k), aux). x: (t, d). The reference's arithmetic in that
    dtype: ``jax.nn.softmax``'s exp(l - max) / sum rounded at each step
    (in fp32 the fused ``torch.softmax`` does the same steps; in a
    narrower dtype it rounds once, so the steps are written out), and
    ``jax.lax.top_k``'s ties to the lower expert (a stable sort, the
    cheapest exact rule on the card: in bf16 the probabilities of a random
    router tie often). Over the data axis ``aux`` is the whole batch's;
    over an expert-split model axis the logits are gathered first, so
    every rank routes alike."""
    router = params["router"]
    if split is not None and not split.experts:
        router = split.copy(router)
    rd = cfg.router_dtype
    logits = x.to(rd) @ router.to(rd)
    if split is not None and split.experts:
        logits = split.gather(logits, 1)
    if rd == torch.float32:
        probs = torch.softmax(logits, dim=-1)
    else:
        e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
        probs = e / e.sum(dim=-1, keepdim=True)
    weights, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, ids = weights[:, :cfg.top_k], ids[:, :cfg.top_k]
    weights = weights / weights.sum(dim=-1, keepdim=True)
    # Switch-style load balance: E * sum_e f_e * p_e.
    t = x.shape[0]
    mean_prob = probs.mean(dim=0)
    tm = _data_split()
    if tm is None:
        density = torch.zeros(cfg.n_experts, device=x.device).scatter_add_(
            0, ids.reshape(-1), torch.ones(ids.numel(), device=x.device)) / (
            t * cfg.top_k)
    else:
        density = _counts(ids, cfg.n_experts)[1].float() / (
            _global_tokens(t) * cfg.top_k)
        mean_prob = tm.batch_mean(mean_prob)
    aux = cfg.n_experts * torch.sum(density * mean_prob)
    if split is not None:
        aux = split.once(aux)
    return weights.to(x.dtype), ids, aux


def _expert_ffn(params: Params, x_e):
    """Batched per-expert SwiGLU. x_e: (E, C, d) -> (E, C, d)."""
    dt = x_e.dtype
    g = torch.bmm(x_e, params["expert_gate"].to(dt))
    u = torch.bmm(x_e, params["expert_up"].to(dt))
    return torch.bmm(F.silu(g) * u, params["expert_down"].to(dt))


def _moe_dense_mask(params: Params, cfg: MoEConfig, x2,
                    split: Optional[_ModelSplit] = None):
    """Every expert this rank holds on every token, weighted by the
    token's gate."""
    weights, ids, aux = _route(params, cfg, x2, split)
    gates = torch.zeros((x2.shape[0], cfg.n_experts), dtype=x2.dtype,
                        device=x2.device).scatter_add_(1, ids, weights)
    lo, n = _local_experts(split, cfg.n_experts)
    out = torch.zeros_like(x2)
    for j in range(n):
        e = lo + j
        g = x2 @ params["expert_gate"][j].to(x2.dtype)
        u = x2 @ params["expert_up"][j].to(x2.dtype)
        y = (F.silu(g) * u) @ params["expert_down"][j].to(x2.dtype)
        out = out + gates[:, e:e + 1] * y
    return out, aux


def _moe_capacity(params: Params, cfg: MoEConfig, x2,
                  split: Optional[_ModelSplit] = None):
    """Sort-based capacity dispatch; no step waits on the host. Under a
    model split the rank fills and runs only its experts' rows."""
    t, d = x2.shape
    weights, ids, aux = _route(params, cfg, x2, split)
    e, k = cfg.n_experts, cfg.top_k
    cap = capacity(cfg, _global_tokens(t))
    flat_ids = ids.reshape(-1)                                 # (t*k,)
    order = torch.argsort(flat_ids, stable=True)
    sorted_ids = flat_ids[order]
    # Rank within the expert: position minus the expert's first position,
    # after the expert's choices in the batch blocks before this one.
    first = torch.searchsorted(sorted_ids, sorted_ids, side="left")
    rank = torch.arange(t * k, device=x2.device) - first
    if _data_split() is not None:
        rank = rank + _counts(ids, e)[0][sorted_ids]
    keep = rank < cap
    dest = torch.where(keep, sorted_ids * cap + rank,
                       torch.full_like(rank, e * cap))
    src_token = order // k
    # This rank's experts' rows of the (e * cap) buffer; the choices it
    # does not run (dropped, or another rank's) go to one extra row.
    lo, n = _local_experts(split, e)
    rows = n * cap
    local = dest - lo * cap
    mine = keep & (local >= 0) & (local < rows)
    slot = torch.where(mine, local, torch.full_like(local, rows))
    buf = torch.zeros((rows + 1, d), dtype=x2.dtype, device=x2.device)
    buf[slot] = x2[src_token]
    y_flat = _expert_ffn(params, buf[:-1].reshape(n, cap, d)).reshape(
        rows, d)
    gathered = torch.where(mine[:, None], y_flat[slot.clamp(max=rows - 1)],
                           torch.zeros((), dtype=x2.dtype, device=x2.device))
    # Choice j of the flat (t*k) list sits at sorted position inv[j].
    inv = torch.empty_like(order)
    inv[order] = torch.arange(t * k, device=x2.device)
    out = (gathered[inv] * weights.reshape(-1, 1)).reshape(t, k, d).sum(1)
    return out, aux


def moe_apply(params: Params, cfg: MoEConfig, x) -> Tuple[torch.Tensor,
                                                          torch.Tensor]:
    """x: (b, s, d) -> (out (b, s, d), aux loss). The capacity path's
    buffer is sized by b * s, padded rows included, as the reference's."""
    b, s, d = x.shape
    x2 = x.reshape(b * s, d)
    split = _model_split(cfg)
    xr = x2 if split is None else split.copy(x2)
    if cfg.impl == "capacity":
        out, aux = _moe_capacity(params, cfg, xr, split)
    elif cfg.impl == "dense_mask":
        out, aux = _moe_dense_mask(params, cfg, xr, split)
    else:
        raise ValueError(f"moe_impl {cfg.impl!r}: want 'capacity' or "
                         f"'dense_mask'")
    if split is not None:
        out = split.reduce(out)             # the ranks' experts summed
    if cfg.n_shared:
        out = out + layers.mlp_apply(params["shared"], cfg.shared_cfg(), x2)
    return out.reshape(b, s, d), aux


def dropped(params: Params, cfg: MoEConfig, x) -> torch.Tensor:
    """Choices the capacity path drops for x (b, s, d): those past their
    expert's capacity, counted on x's device as a 0-d int64 tensor (no
    wait on the host; the caller reads it when it likes). Of
    ``b * s * top_k`` choices in all; over the data axis, the whole
    batch's drops, and over the model axis the same count, on every
    rank."""
    _, ids, _ = _route(params, cfg, x.reshape(-1, x.shape[-1]),
                       _model_split(cfg))
    counts = _counts(ids, cfg.n_experts)[1]
    cap = capacity(cfg, _global_tokens(x.shape[0] * x.shape[1]))
    return (counts - cap).clamp(min=0).sum()
