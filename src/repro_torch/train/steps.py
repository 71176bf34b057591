"""Training step: loss, gradients, clipping, AdamW, optional gradient
accumulation and error-feedback gradient compression (port of
``repro/train/steps.py``).

Gradients come from ``torch.autograd`` through the plain ``sdpa``: the
kernels have no backward (their wrappers raise under grad mode), so a
model trains with ``use_flash=False``, as the reference does (an
encoder and the cross-attention always run the plain ``sdpa``). Every
family trains: the loss asks ``forward_aux`` for the plain chunked SSD
scan in fp32 (``ssd_kernel=False``, the reference's default path), so
the Mamba layers never reach the scan kernel, and it adds
``aux_weight`` times the mixtures' load-balancing loss. A parameter no
loss term reaches (whisper-medium's encoder, whose output no layer
reads) gets a zero gradient, as ``jax.value_and_grad`` gives it, so
AdamW's weight decay still moves it.

The step updates the parameters and the optimizer moments in place (the
reference jits a step over a donated state and returns new trees).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs import ModelConfig
from repro_torch.dist import compression, sharding
from repro_torch.models import layers
from repro_torch.models import transformer as T
from repro_torch.optim import adamw, schedule
from repro_torch.train import dist as train_dist
from repro_torch.tree import tree_items, tree_leaves, tree_map, tree_unflatten

@dataclasses.dataclass
class TrainState:
    params: Any
    opt: Dict[str, Any]
    step: torch.Tensor            # 0-d int32
    ef: Any = None                # error-feedback residual (compressed grads)

    def tree(self) -> dict:
        t = {"params": self.params, "opt": self.opt, "step": self.step}
        if self.ef is not None:
            t["ef"] = self.ef
        return t

    @classmethod
    def from_tree(cls, t) -> "TrainState":
        return cls(params=t["params"], opt=t["opt"], step=t["step"],
                   ef=t.get("ef"))


def _scale_groups(tree, n_pos: int) -> List[int]:
    """For each leaf (``tree_leaves`` order), the index of the reference
    leaf it belongs to: the reference stacks each pattern position's
    block leaves over its periods (its ``lax.scan`` stack), and the
    encoder's over its layers, so a compressed all-reduce carries one
    scale for each such stack."""
    keys: Dict[str, int] = {}
    out = []
    for path, _ in tree_items(tree):
        parts = path.split("/")
        if "blocks" in parts:
            i = parts.index("blocks")
            per = n_pos if parts[:i] == [] else 1     # decoder / encoder
            parts[i + 1] = str(int(parts[i + 1]) % per)
        out.append(keys.setdefault("/".join(parts), len(keys)))
    return out


def _compress(grads, ef, n_pos: int, tm=None, leaf_axes=None):
    """The int8 round trip (with the error-feedback residual ``ef``, or
    None) at one scale for each reference leaf (``_scale_groups``): the
    max |g| over its layers and, on a mesh, over the axes each shard is
    split on (``leaf_axes``), so every rank quantises with the scale of
    the whole averaged gradient."""

    def scales(tree) -> List[torch.Tensor]:
        amax = [compression.max_abs(g) for g in tree_leaves(tree)]
        if tm is not None:
            by_axes: Dict[tuple, List[int]] = {}
            for i, axes in enumerate(leaf_axes):
                if axes:
                    by_axes.setdefault(axes, []).append(i)
            for axes, idx in by_axes.items():
                got = tm.all_max(torch.stack([amax[i] for i in idx]), axes)
                for j, i in enumerate(idx):
                    amax[i] = got[j]
        groups = _scale_groups(tree, n_pos)
        top: Dict[int, torch.Tensor] = {}
        for g, a in zip(groups, amax):
            top[g] = torch.maximum(top[g], a) if g in top else a
        return [top[g] for g in groups]

    if ef is None:
        return compression.int8_roundtrip(grads, scales(grads)), None
    return compression.ErrorFeedback.compress(grads, ef, scales)


def init_state(cfg: ModelConfig, seed: int = 0, device=None,
               error_feedback: bool = False,
               ruleset: Optional[sharding.Ruleset] = None) -> TrainState:
    """Random fp32 master parameters (``T.init_params`` from a
    ``torch.Generator`` seeded with ``seed``), fresh AdamW state, step 0.
    The layers cast the weights to the compute dtype at use, so gradients
    reach the fp32 leaves. Under a ``ruleset`` with a mesh, this rank's
    shards of the same seed's full tree (``sharding.shard_tree``; ``opt``
    and ``ef`` resolve by leaf name as the parameters), so one rank and N
    ranks start from equal parameters."""
    device = resolve_device(device)
    params = T.init_params(cfg, torch.Generator(device=device).manual_seed(
        seed), device=device, dtype=torch.float32)
    if ruleset is not None and ruleset.mesh is not None:
        params = sharding.shard_tree(params, ruleset.mesh, ruleset)
    ef = compression.ErrorFeedback.init(params) if error_feedback else None
    return TrainState(params=params, opt=adamw.adamw_init(params),
                      step=torch.zeros((), dtype=torch.int32, device=device),
                      ef=ef)


def state_shapes(cfg: ModelConfig, error_feedback: bool = False) -> dict:
    """``init_state``'s tree as meta tensors of the global shapes: what
    a sharded state's leaves are gathered back to (``leaf_specs``,
    ``CheckpointManager.save``)."""
    params = T.param_shapes(cfg)
    ef = compression.ErrorFeedback.init(params) if error_feedback else None
    return TrainState(params=params, opt=adamw.adamw_init(params),
                      step=torch.zeros((), dtype=torch.int32, device="meta"),
                      ef=ef).tree()


def cross_entropy(logits, labels, vocab: Optional[int] = None
                  ) -> torch.Tensor:
    """Mean token NLL, fp32 (``layers.wide``). Inside a train step whose
    model axis shards the vocabulary (``vocab`` its global size), the
    logits are this rank's columns: the max, the sum of exponentials and
    the gold logit are each combined over the axis from (b, s) tensors,
    and the logits are never gathered."""
    logits = logits.to(layers.wide(logits.dtype))
    train = None if vocab is None else train_dist.sharded("vocab", vocab)
    if train is None:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
        return torch.mean(logz - gold)
    tm, axis = train
    m = tm.all_max(logits.amax(dim=-1), (axis,))
    total = tm.reduce(torch.exp(logits - m[..., None]).sum(dim=-1), axis)
    local = labels.long() - tm.mesh.index(axis) * logits.shape[-1]
    owned = (local >= 0) & (local < logits.shape[-1])
    gold = torch.gather(logits, -1, torch.where(
        owned, local, torch.zeros_like(local))[..., None])[..., 0]
    gold = tm.reduce(torch.where(owned, gold, torch.zeros_like(gold)), axis)
    return torch.mean(m + torch.log(total) - gold)


def loss_fn(params, cfg: ModelConfig, batch, aux_weight: float = 0.01):
    """(nll + aux_weight * aux, {"nll", "aux"}) of ``batch`` ({"tokens",
    "labels"} (b, s), and "frontend" (b, n, d_model) where the model
    reads one) through the cache-less ``T.forward_aux``, its Mamba layers
    on the plain chunked scan. ``aux`` is the mixtures' load-balancing
    loss summed over layers (0 without experts)."""
    logits, _, aux = T.forward_aux(params, cfg, batch["tokens"],
                                   frontend_embeds=batch.get("frontend"),
                                   ssd_kernel=False)
    nll = cross_entropy(logits, batch["labels"], vocab=cfg.vocab)
    return nll + aux_weight * aux, {"nll": nll, "aux": aux}


def _average_grads(grads: List[torch.Tensor], specs, tm) -> List[torch.Tensor]:
    """Gradients averaged over the mesh's batch axes: each leaf summed
    over the batch axes it is not sharded on (FSDP's gather already
    summed a leaf's gradient over "data" in its backward), leaves
    summed alike in flat buckets, then divided by the ranks of the batch
    axes (a batch that replicates over an axis gives equal gradients,
    whose mean is the same)."""
    axes_all = tm.data_axes
    n = tm.size(axes_all)
    if n == 1:
        return grads
    out = list(grads)
    buckets: Dict[tuple, List[int]] = {}
    for i, (g, spec) in enumerate(zip(grads, specs)):
        axes = tuple(a for a in axes_all
                     if a not in sharding.spec_axes(spec))
        if axes:
            buckets.setdefault((axes, g.dtype), []).append(i)
    for (axes, _), idx in buckets.items():
        while idx:
            take, size = [], 0
            while idx and (not take or size + grads[idx[0]].numel()
                           <= _BUCKET):
                size += grads[idx[0]].numel()
                take.append(idx.pop(0))
            flat = torch.cat([grads[i].reshape(-1) for i in take])
            tm.all_reduce(flat, axes)
            for i, part in zip(take, flat.split([grads[i].numel()
                                                 for i in take])):
                out[i] = part.view_as(grads[i])
    return [g / n for g in out]


# Elements a flat gradient bucket holds at most (128 MiB of fp32).
_BUCKET = 1 << 25


def make_grad_fn(cfg: ModelConfig, accum_steps: int = 1,
                 ruleset: Optional[sharding.Ruleset] = None):
    """Returns grads(params, batch) -> (loss, parts, grads, tm): the
    loss of the global ``batch`` and its gradients, averaged over
    ``accum_steps`` micro-batches, for ``params``, and the step's
    ``train_dist.TrainMesh`` (None without a mesh; its ``traffic``
    counts the collectives).

    Under a ``ruleset`` with a mesh ``params`` are this rank's shards:
    the rank takes its rows of each micro-batch
    (``train_dist.batch_block``), gathers the leaves FSDP shards over
    "data" (``TrainMesh.gather``), runs the loss with the mesh installed
    (``train_dist.use_mesh``), and averages the gradients over the batch
    axes; ``loss`` and ``parts`` are the global ones, and the gradients
    are this rank's shards of the single-device step's."""
    mesh = None if ruleset is None else ruleset.mesh
    spec_of = None if mesh is None else sharding.leaf_specs(
        T.param_shapes(cfg), ruleset)

    def one(params, batch, tm, specs):
        # Leaves that share the parameters' storage and track gradients,
        # so the parameters themselves never require grad.
        tracked = tree_map(lambda p: p.detach().requires_grad_(), params)
        leaves = tree_leaves(tracked)
        with torch.enable_grad(), train_dist.use_mesh(tm):
            used = leaves
            if tm is not None:
                used = [tm.gather(x, spec.index("data"), "data")
                        if "data" in spec else x
                        for x, spec in zip(leaves, specs)]
            loss, parts = loss_fn(tree_unflatten(params, used), cfg, batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, leaves)]
        return loss.detach(), {k: v.detach() for k, v in parts.items()}, \
            grads

    def grads_fn(params, batch):
        tm = specs = None
        if mesh is not None:
            specs = [spec_of[path] for path, _ in tree_items(params)]
            batch, axes = train_dist.batch_block(batch, ruleset, accum_steps)
            tm = train_dist.TrainMesh(ruleset, axes)
        if accum_steps == 1:
            loss, parts, grads = one(params, batch, tm, specs)
        else:
            n = batch["tokens"].shape[0] // accum_steps
            grads = [torch.zeros_like(p, dtype=torch.float32)
                     for p in tree_leaves(params)]
            loss = torch.zeros((), dtype=torch.float32,
                               device=batch["tokens"].device)
            for i in range(accum_steps):
                mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
                loss_i, _, g = one(params, mb, tm, specs)
                for a, b in zip(grads, g):
                    a.add_(b)
                loss = loss + loss_i
            grads = [g / accum_steps for g in grads]
            loss = loss / accum_steps
            parts = {"nll": loss, "aux": torch.zeros_like(loss)}
        if tm is not None:
            grads = _average_grads(grads, specs, tm)
            n = tm.size(tm.data_axes)
            loss = tm.all_reduce(loss.clone(), tm.data_axes) / n
            parts = dict(parts, nll=tm.all_reduce(parts["nll"].clone(),
                                                  tm.data_axes) / n)
        return loss, parts, tree_unflatten(params, grads), tm

    return grads_fn


def make_train_step(cfg: ModelConfig,
                    sched: schedule.ScheduleConfig = schedule.ScheduleConfig(),
                    opt_cfg: adamw.AdamWConfig = adamw.AdamWConfig(),
                    clip_norm: float = 1.0,
                    accum_steps: int = 1,
                    compress_grads: bool = False,
                    error_feedback: bool = False,
                    ruleset: Optional[sharding.Ruleset] = None):
    """Returns step(state_tree, batch) -> (state_tree, metrics).

    ``accum_steps`` splits the batch's leading dim into that many
    micro-batches and averages their gradients. ``compress_grads`` sends
    the gradients through the int8 round trip; ``error_feedback`` also
    carries the quantization error in ``TrainState.ef`` and re-injects it
    the next step, so the state must come from ``init_state(...,
    error_feedback=True)``.

    Under a ``ruleset`` with a mesh (``launch.train.build``) the state is
    this rank's shards (``init_state(..., ruleset=)``) and ``batch`` the
    global batch; the step computes what the single-device step computes
    (``make_grad_fn``; the gradients compressed with each leaf's global
    scale, the norm summed over ranks, AdamW on the shards), and its
    metrics are global. ``step.traffic`` holds the last step's
    collectives and bytes."""
    if error_feedback and not compress_grads:
        raise ValueError("error_feedback rides on compress_grads")
    grads_fn = make_grad_fn(cfg, accum_steps, ruleset)
    spec_of = None
    if ruleset is not None and ruleset.mesh is not None:
        spec_of = sharding.leaf_specs(T.param_shapes(cfg), ruleset)

    def step(state_tree, batch):
        state = TrainState.from_tree(state_tree)
        loss, parts, grads, tm = grads_fn(state.params, batch)
        leaf_axes = None if tm is None else [
            sharding.spec_axes(spec_of[path])
            for path, _ in tree_items(state.params)]
        ef: Optional[Any] = state.ef
        if compress_grads:
            if error_feedback and ef is None:
                raise ValueError("init_state(..., error_feedback=True) "
                                 "required")
            grads, ef = _compress(grads, ef if error_feedback else None,
                                  len(cfg.pattern), tm, leaf_axes)
        grads, gnorm = adamw.clip_by_global_norm(
            grads, clip_norm, leaf_axes,
            None if tm is None else tm.all_reduce)
        lr = schedule.learning_rate(state.step, sched)
        params, opt = adamw.adamw_update(grads, state.opt, state.params, lr,
                                         opt_cfg)
        new_state = TrainState(params=params, opt=opt, step=state.step + 1,
                               ef=ef)
        metrics = {"loss": loss, "nll": parts["nll"], "aux": parts["aux"],
                   "grad_norm": gnorm, "lr": lr}
        step.traffic = None if tm is None else dict(tm.traffic)
        return new_state.tree(), metrics

    step.traffic = None
    return step
