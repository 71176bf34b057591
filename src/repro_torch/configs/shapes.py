"""The dry run's input shapes (port of ``repro/configs/shapes.py``, the
same data), one set shared by every architecture.

``decode_*`` / ``long_*`` trace one decode step (one new token a slot
against a cache of ``seq_len`` rows); the others trace the train step or
the prefill (``launch.dryrun``). ``long_500k`` needs sub-quadratic
sequence mixing and is runnable only for the SSM and hybrid
architectures; ``runnable`` gives the reference's reason for the skips.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                   # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

# Archs whose sequence mixing is sub-quadratic end-to-end (SSM / hybrid):
# only these run long_500k.
SUBQUADRATIC = ("jamba-v0.1-52b", "mamba2-370m")


def runnable(arch_id: str, shape: str) -> Tuple[bool, Optional[str]]:
    if shape == "long_500k" and arch_id not in SUBQUADRATIC:
        return False, ("full quadratic attention at 524k tokens; skipped per "
                       "assignment (see DESIGN.md §6)")
    return True, None


def cells(arch_ids):
    """All (arch, shape) dry-run cells with skip annotations."""
    out = []
    for a in arch_ids:
        for s in SHAPES:
            ok, why = runnable(a, s)
            out.append((a, s, ok, why))
    return out
