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
from typing import Any, Dict, Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs import ModelConfig
from repro_torch.dist import compression
from repro_torch.models import transformer as T
from repro_torch.optim import adamw, schedule
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

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


def _stack(blocks, n_pos):
    """Per pattern position, its layers' dicts stacked leaf by leaf."""
    return [tree_map(lambda *ls: torch.stack(ls), *blocks[pos::n_pos])
            for pos in range(n_pos)]


def _unstack(stacked):
    n_pos = len(stacked)
    periods = tree_leaves(stacked[0])[0].shape[0]
    return [tree_map(lambda leaf: leaf[i // n_pos], stacked[i % n_pos])
            for i in range(periods * n_pos)]


def _stacked(tree, n_pos: int):
    """A parameter-shaped tree in the reference's layout, a copy: each
    pattern position's block leaves stacked over its periods (its
    ``lax.scan`` stack), and the encoder's over its layers."""
    out = dict(tree, blocks=_stack(tree["blocks"], n_pos))
    if "encoder" in tree:
        out["encoder"] = dict(tree["encoder"],
                              blocks=_stack(tree["encoder"]["blocks"], 1))
    return out


def _unstacked(tree):
    """The port's layout (one dict per layer) of a ``_stacked`` tree."""
    out = dict(tree, blocks=_unstack(tree["blocks"]))
    if "encoder" in tree:
        out["encoder"] = dict(tree["encoder"],
                              blocks=_unstack(tree["encoder"]["blocks"]))
    return out


def _compress(grads, ef, n_pos: int):
    """The int8 round trip (with the error-feedback residual ``ef``, or
    None) over the reference's leaves: one scale for each block leaf
    stacked over its pattern position's periods, as its compressed
    all-reduce would carry."""
    if ef is None:
        return _unstacked(compression.int8_roundtrip(
            _stacked(grads, n_pos))), None
    grads, ef = compression.ErrorFeedback.compress(_stacked(grads, n_pos),
                                                   _stacked(ef, n_pos))
    return _unstacked(grads), _unstacked(ef)


def init_state(cfg: ModelConfig, seed: int = 0, device=None,
               error_feedback: bool = False) -> TrainState:
    """Random fp32 master parameters (``T.init_params`` from a
    ``torch.Generator`` seeded with ``seed``), fresh AdamW state, step 0.
    The layers cast the weights to the compute dtype at use, so gradients
    reach the fp32 leaves."""
    device = resolve_device(device)
    params = T.init_params(cfg, torch.Generator(device=device).manual_seed(
        seed), device=device, dtype=torch.float32)
    ef = compression.ErrorFeedback.init(params) if error_feedback else None
    return TrainState(params=params, opt=adamw.adamw_init(params),
                      step=torch.zeros((), dtype=torch.int32, device=device),
                      ef=ef)


def cross_entropy(logits, labels) -> torch.Tensor:
    """Mean token NLL, fp32."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.mean(logz - gold)


def loss_fn(params, cfg: ModelConfig, batch, aux_weight: float = 0.01):
    """(nll + aux_weight * aux, {"nll", "aux"}) of ``batch`` ({"tokens",
    "labels"} (b, s), and "frontend" (b, n, d_model) where the model
    reads one) through the cache-less ``T.forward_aux``, its Mamba layers
    on the plain chunked scan. ``aux`` is the mixtures' load-balancing
    loss summed over layers (0 without experts)."""
    logits, _, aux = T.forward_aux(params, cfg, batch["tokens"],
                                   frontend_embeds=batch.get("frontend"),
                                   ssd_kernel=False)
    nll = cross_entropy(logits, batch["labels"])
    return nll + aux_weight * aux, {"nll": nll, "aux": aux}


def make_train_step(cfg: ModelConfig,
                    sched: schedule.ScheduleConfig = schedule.ScheduleConfig(),
                    opt_cfg: adamw.AdamWConfig = adamw.AdamWConfig(),
                    clip_norm: float = 1.0,
                    accum_steps: int = 1,
                    compress_grads: bool = False,
                    error_feedback: bool = False):
    """Returns step(state_tree, batch) -> (state_tree, metrics).

    ``accum_steps`` splits the batch's leading dim into that many
    micro-batches and averages their gradients. ``compress_grads`` sends
    the gradients through the int8 round trip; ``error_feedback`` also
    carries the quantization error in ``TrainState.ef`` and re-injects it
    the next step, so the state must come from ``init_state(...,
    error_feedback=True)``."""
    if error_feedback and not compress_grads:
        raise ValueError("error_feedback rides on compress_grads")

    def grads_of(params, batch):
        # Leaves that share the parameters' storage and track gradients,
        # so the parameters themselves never require grad.
        tracked = tree_map(lambda p: p.detach().requires_grad_(), params)
        leaves = tree_leaves(tracked)
        with torch.enable_grad():
            loss, parts = loss_fn(tracked, cfg, batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, leaves)]
        return (loss.detach(), {k: v.detach() for k, v in parts.items()},
                tree_unflatten(params, grads))

    def step(state_tree, batch):
        state = TrainState.from_tree(state_tree)
        if accum_steps == 1:
            loss, parts, grads = grads_of(state.params, batch)
        else:
            n = batch["tokens"].shape[0] // accum_steps
            grads = tree_map(lambda p: torch.zeros_like(
                p, dtype=torch.float32), state.params)
            loss = torch.zeros((), dtype=torch.float32,
                               device=batch["tokens"].device)
            for i in range(accum_steps):
                mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
                loss_i, _, g = grads_of(state.params, mb)
                tree_map(lambda a, b: a.add_(b), grads, g)
                loss = loss + loss_i
            grads = tree_map(lambda g: g / accum_steps, grads)
            loss = loss / accum_steps
            parts = {"nll": loss, "aux": torch.zeros_like(loss)}
        ef: Optional[Any] = state.ef
        if compress_grads:
            if error_feedback and ef is None:
                raise ValueError("init_state(..., error_feedback=True) "
                                 "required")
            grads, ef = _compress(grads, ef if error_feedback else None,
                                  len(cfg.pattern))
        grads, gnorm = adamw.clip_by_global_norm(grads, clip_norm)
        lr = schedule.learning_rate(state.step, sched)
        params, opt = adamw.adamw_update(grads, state.opt, state.params, lr,
                                         opt_cfg)
        new_state = TrainState(params=params, opt=opt, step=state.step + 1,
                               ef=ef)
        metrics = {"loss": loss, "nll": parts["nll"], "aux": parts["aux"],
                   "grad_norm": gnorm, "lr": lr}
        return new_state.tree(), metrics

    return step
