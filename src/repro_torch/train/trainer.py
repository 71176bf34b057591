"""Fault-tolerant training loop (port of ``repro/train/trainer.py``):

* restore from the latest checkpoint on start, or initialise;
* periodic checkpoints (parameters, optimizer, step and the data cursor),
  asynchronous by default;
* recovery: a step that raises ``SimulatedPreemption`` is retried after
  restoring the last checkpoint (at most ``max_recoveries`` times);
* straggler watchdog: each step's wall time against the rolling median of
  the last 50; a step slower than ``straggler_factor`` times it fires
  ``on_straggler`` (here it logs and counts).

On a mesh (``ruleset``: the build's, ``launch.train.build``) every rank
runs this loop: the state is its shards, restored with the ruleset (the
elastic restore) and saved whole by rank 0; every rank hands the step
the global batch, whose block the step takes (``train.dist
.batch_block``), and logs the global loss the step returns. The
watchdog and ``SimulatedPreemption`` act on each rank as on one.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import SyntheticLMData
from repro_torch.train import steps as steps_mod


@dataclasses.dataclass
class TrainerConfig:
    checkpoint_dir: str
    total_steps: int = 100
    checkpoint_every: int = 50
    keep_checkpoints: int = 3
    async_checkpoint: bool = True
    log_every: int = 10
    straggler_factor: float = 3.0
    max_recoveries: int = 3


class Trainer:
    """Drives ``step_fn(state_tree, batch) -> (state_tree, metrics)`` over
    ``data`` on ``device`` (cuda unless the caller passes cpu);
    ``init_state_fn()`` returns a fresh state tree, which also gives a
    restore its structure. ``frontend_fn(batch_size)``, where given, makes
    each batch's "frontend" (a stubbed audio or vision frontend's
    embeddings). ``ruleset``: the sharding of a state on a mesh."""

    def __init__(self, cfg: TrainerConfig, model_cfg, data: SyntheticLMData,
                 step_fn: Callable, init_state_fn: Callable, device=None,
                 fail_injector: Optional[Callable] = None,
                 frontend_fn: Optional[Callable] = None, ruleset=None):
        self.cfg = cfg
        self.model_cfg = model_cfg
        self.data = data
        self.step_fn = step_fn
        self.init_state_fn = init_state_fn
        self.device = resolve_device(device)
        self.fail_injector = fail_injector
        self.frontend_fn = frontend_fn
        self.ruleset = ruleset
        self._shapes = None         # the state's global shapes, on a mesh
        self.ckpt = CheckpointManager(cfg.checkpoint_dir,
                                      keep=cfg.keep_checkpoints,
                                      async_save=cfg.async_checkpoint)
        self.metrics_log: List[Dict[str, float]] = []
        self.straggler_steps: List[int] = []
        self.recoveries = 0
        self._durations: List[float] = []
        self._saved_step: Optional[int] = None

    # -- state ------------------------------------------------------------
    def _restore_or_init(self):
        state_tree = self.init_state_fn()
        last = self.ckpt.latest_step()
        if self.ruleset is not None and self.ruleset.mesh is not None:
            self._shapes = steps_mod.state_shapes(self.model_cfg,
                                                  "ef" in state_tree)
        if last is not None:
            state_tree, manifest = self.ckpt.restore(state_tree,
                                                     ruleset=self.ruleset)
            self.data.load_state_dict(manifest["extra"]["data"])
            self._saved_step = last
        return state_tree

    def _save(self, state_tree) -> None:
        step = int(state_tree["step"])
        self.ckpt.save(step, state_tree,
                       extra={"data": self.data.state_dict()},
                       ruleset=self.ruleset, shapes=self._shapes)
        self._saved_step = step

    # -- loop --------------------------------------------------------------
    def run(self) -> Dict[str, Any]:
        state = self._restore_or_init()
        step = int(state["step"])
        while step < self.cfg.total_steps:
            tokens, labels = self.data.batch_at(step)
            batch = {"tokens": torch.from_numpy(tokens).to(self.device),
                     "labels": torch.from_numpy(labels).to(self.device)}
            if self.frontend_fn is not None:
                batch["frontend"] = self.frontend_fn(tokens.shape[0])
            t0 = time.perf_counter()
            try:
                if self.fail_injector is not None:
                    self.fail_injector(step)
                state, metrics = self.step_fn(state, batch)
                float(metrics["loss"])     # waits for the step's work
            except _RECOVERABLE:
                self.recoveries += 1
                if self.recoveries > self.cfg.max_recoveries:
                    raise
                self.ckpt.wait()
                state = self._restore_or_init()
                step = int(state["step"])
                continue
            dt = time.perf_counter() - t0
            self._watchdog(step, dt)
            step += 1
            if step % self.cfg.log_every == 0 or step == self.cfg.total_steps:
                self.metrics_log.append(
                    {k: float(v) for k, v in metrics.items()}
                    | {"step": step, "dt": dt})
            if step % self.cfg.checkpoint_every == 0:
                self._save(state)
        # The reference saves again here even when the last step was just
        # saved; an unchanged state is not written twice.
        if self._saved_step != step:
            self._save(state)
        self.ckpt.wait()
        return {"state": state, "metrics": self.metrics_log,
                "stragglers": self.straggler_steps,
                "recoveries": self.recoveries}

    def _watchdog(self, step: int, dt: float) -> None:
        self._durations.append(dt)
        hist = self._durations[-50:]
        if len(hist) >= 8:
            med = float(np.median(hist))
            if dt > self.cfg.straggler_factor * med:
                self.straggler_steps.append(step)
                self.on_straggler(step, dt, med)

    def on_straggler(self, step: int, dt: float, median: float) -> None:
        print(f"[watchdog] step {step}: {dt:.3f}s vs median {median:.3f}s "
              f"(>{self.cfg.straggler_factor}x) — straggler flagged")


class SimulatedPreemption(RuntimeError):
    """Raised by fail injectors to model node loss mid-run."""


_RECOVERABLE = (SimulatedPreemption,)
