"""PyTorch + CUDA port of the ``repro`` serving path for NVIDIA Hopper.

The JAX package ``repro`` is the reference; this package imports nothing
from it (and never imports JAX). Every entry point runs on ``cuda`` unless
the caller passes ``device="cpu"``; without a GPU and without that explicit
choice it raises instead of quietly running on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` by default.

    ``None`` means ``cuda``; asking for CUDA on a machine without it
    raises. ``device="cpu"`` (or a ``torch.device`` of type cpu) is the
    only way onto the CPU, where the kernels' plain versions run;
    ``device="meta"``, asked for explicitly, builds shapes without
    memory (the dry run's tensors: ``launch.dryrun``)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}")
    return dev
