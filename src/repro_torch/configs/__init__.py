"""Model configurations: the dense subset of the reference's
``ModelConfig`` and the two dense GQA decoders the port serves.

``get_config(name)`` returns the full configuration, ``get_smoke(name)``
the reduced same-family one used by the CPU tests. Field values are the
reference's own (``repro/configs/<arch>.py``), head_dim included.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Optional

import torch

ALIASES = {
    "qwen3-4b": "qwen3_4b",
    "qwen2-0.5b": "qwen2_0_5b",
}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Dense decoder-only transformer (pre-norm RMSNorm, GQA attention
    with optional qk-norm / qkv-bias and half-split RoPE, SwiGLU or GELU
    MLP). Paged attention always goes through the kernel wrappers
    (``kernels.ops``), and softmax probabilities are always fp32: the
    reference's ``use_flash`` and ``attn_probs_fp32`` have no field here."""

    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0            # 0 -> d_model // n_heads
    activation: str = "swiglu"   # "swiglu" | "gelu"
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: Optional[float] = 10000.0
    compute_dtype: str = "float32"

    @property
    def dhead(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)


def _module(name: str):
    mod = ALIASES.get(name, name).replace("-", "_").replace(".", "_")
    return importlib.import_module(f"repro_torch.configs.{mod}")


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke(name: str) -> ModelConfig:
    return _module(name).SMOKE


def list_archs():
    return list(ALIASES)
