"""Gradient compression: symmetric int8 quantization with error feedback
(port of ``repro/dist/compression.py``, on one device: what a compressed
all-reduce would carry, applied to the step's gradients).

``int8_roundtrip`` quantizes each leaf to int8 with one fp32 scale
(max|g| / 127) and dequantizes it at once: the error of an element is at
most scale / 2. ``ErrorFeedback`` is the EF-SGD residual: the quantization
error of step t is added back into the gradient at step t + 1, so the
compression bias does not accumulate over training.

``scales`` hands the round trip each leaf's max|g| instead of its own:
the train step's one scale for each of the reference's stacked leaves
and, on a mesh, the max over the ranks a leaf is sharded on, so every
rank quantises its block of the averaged gradient with the scale of the
whole leaf, as the reference does after GSPMD's reduction
(``train.steps._compress``).
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

import torch

from repro_torch.tree import tree_map


def max_abs(g: torch.Tensor) -> torch.Tensor:
    """max|g| in fp32, 0-d: the quantisation scale times 127."""
    return g.float().abs().max()


def quantize(g: torch.Tensor, amax: torch.Tensor) -> torch.Tensor:
    """``g`` to int8 and back at the scale ``amax / 127``."""
    g32 = g.float()
    scale = amax / 127.0
    # An all-zero leaf keeps a finite scale and quantizes to exact zeros.
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(g32 / safe), -127, 127).to(torch.int8)
    return (q.float() * safe).to(g.dtype)


def _quantize_leaf(g: torch.Tensor) -> torch.Tensor:
    return quantize(g, max_abs(g))


def int8_roundtrip(grads: Any, scales: Optional[List[torch.Tensor]] = None
                   ) -> Any:
    """Every leaf quantized to int8 and back: |err| <= max|g| / 254 an
    element (half an int8 step at the leaf's scale). ``scales``: each
    leaf's max|g| (``tree_leaves`` order) in place of its own."""
    if scales is None:
        return tree_map(_quantize_leaf, grads)
    it = iter(scales)
    return tree_map(lambda g: quantize(g, next(it)), grads)


class ErrorFeedback:
    """Residual accumulator for compressed gradients.

    residual = ErrorFeedback.init(grads)          # fp32 zeros
    compressed, residual = ErrorFeedback.compress(grads, residual)

    ``compressed`` is the int8 round trip of ``grads + residual``; the new
    residual is exactly the quantization error, re-injected next step.
    """

    @staticmethod
    def init(grads: Any) -> Any:
        return tree_map(lambda g: torch.zeros_like(g, dtype=torch.float32),
                        grads)

    @staticmethod
    def compress(grads: Any, residual: Any,
                 scales: Optional[Callable[[Any], List[torch.Tensor]]] = None
                 ) -> Tuple[Any, Any]:
        """``scales(corrected)``, where given, gives the round trip its
        scales (``int8_roundtrip``)."""
        corrected = tree_map(lambda g, r: g.float() + r, grads, residual)
        compressed = int8_roundtrip(
            corrected, None if scales is None else scales(corrected))
        new_residual = tree_map(lambda c, q: c - q.float(), corrected,
                                compressed)
        return compressed, new_residual
