"""Learning-rate schedules: warmup, then cosine, linear or constant (port
of ``repro/optim/schedule.py``), computed in fp32 tensors as the
reference computes them, not in Python floats."""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class ScheduleConfig:
    # The launcher's defaults (launch/train.py): a short warmup, so that
    # runs of under 100 steps leave the ramp and learn.
    peak_lr: float = 3e-3
    warmup_steps: int = 20
    total_steps: int = 10000
    min_ratio: float = 0.1
    kind: str = "cosine"        # "cosine" | "linear" | "constant"


def learning_rate(step, cfg: ScheduleConfig) -> torch.Tensor:
    """The rate at ``step`` (an int or a 0-d tensor) as a 0-d fp32 tensor
    on the step's device."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = cfg.peak_lr * torch.clamp((step + 1) / max(cfg.warmup_steps, 1),
                                     max=1.0)
    if cfg.kind == "constant":
        return warm
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    if cfg.kind == "linear":
        decay = 1.0 - (1.0 - cfg.min_ratio) * frac
    elif cfg.kind == "cosine":
        decay = cfg.min_ratio + (1.0 - cfg.min_ratio) * 0.5 * (
            1.0 + torch.cos(math.pi * frac))
    else:
        raise ValueError(f"schedule kind {cfg.kind!r}: cosine, linear or "
                         f"constant")
    return torch.where(step < cfg.warmup_steps, warm, cfg.peak_lr * decay)
