"""Model configurations: the reference's ``ModelConfig`` as the port
serves it — dense GQA decoders, mixtures of experts, Mamba-2 stacks and
hybrids of the two, an encoder-decoder (whisper-medium) and a decoder
with gated cross-attention layers (llama-3.2-vision-90b).

``get_config(name)`` returns the full configuration, ``get_smoke(name)``
the reduced same-family one used by the CPU tests; ``name`` is a module
name of ``ARCHS`` (what ``list_archs`` returns, as the reference's does)
or its CLI id in ``ALIASES``. Field values are the reference's own
(``repro/configs/<arch>.py``), head_dim included.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Optional, Tuple

import torch

# The registry's modules, in the reference's order.
ARCHS = [
    "whisper_medium",
    "qwen3_4b",
    "qwen2_0_5b",
    "granite_3_8b",
    "phi3_mini_3_8b",
    "dbrx_132b",
    "llama4_maverick_400b",
    "jamba_v0_1_52b",
    "llama_3_2_vision_90b",
    "mamba2_370m",
]

# CLI ids (--arch) use dashes.
ALIASES = {
    "qwen3-4b": "qwen3_4b",
    "qwen2-0.5b": "qwen2_0_5b",
    "granite-3-8b": "granite_3_8b",
    "phi3-mini-3.8b": "phi3_mini_3_8b",
    "dbrx-132b": "dbrx_132b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "mamba2-370m": "mamba2_370m",
    "whisper-medium": "whisper_medium",
    "llama-3.2-vision-90b": "llama_3_2_vision_90b",
}


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """A non-causal, RoPE-less attention stack over the frontend's
    embeddings (whisper's audio encoder): ``n_layers`` blocks of the
    decoder's width over ``n_ctx`` frontend tokens."""

    n_layers: int
    n_ctx: int


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """A stack of pre-norm blocks (RMSNorm, or LayerNorm where ``norm`` is
    "layer"). Each layer's mixer is named by ``pattern`` (repeated over
    the depth): ``"attn"`` (GQA attention with optional qk-norm /
    qkv-bias and half-split RoPE; without ``rope_theta`` the decoder adds
    sinusoidal positions to its embeddings instead), ``"cross"`` (that
    attention, then a tanh-gated cross-attention to the frontend's
    tokens) or ``"mamba"`` (a Mamba-2 SSD mixer, ``models.mamba``);
    ``d_ff > 0`` adds
    a SwiGLU or GELU MLP to every block, which is a mixture of
    ``n_experts`` SwiGLU experts (``models.moe``, top-``top_k`` routing,
    ``n_shared_experts`` always on) at the pattern positions
    ``moe_positions``. ``encoder`` adds an encoder over the frontend's
    embeddings (``n_frontend_tokens`` of them, width ``d_model``, made by
    a stubbed audio or vision frontend), whose output the cross layers
    read; without it the cross layers read the embeddings themselves.

    ``use_flash`` governs only the cache-less forward (``forward`` without
    caches: scoring, the loss): True runs its attention through the
    full-sequence kernel (``kernels.ops.flash_attention``), False through
    the masked plain ``sdpa``, which is what training differentiates (the
    kernels have no backward). Cached attention always runs its kernels
    (paged prefill and decode, contiguous decode) whatever ``use_flash``
    says; the SSD scan runs its kernel wherever a forward serves, and
    the plain chunked scan where the training step asks for it
    (``forward_aux(..., ssd_kernel=False)``). The reference's
    ``use_ssd_kernel`` and ``scan_layers`` have no field here: the first
    is what the forward's ``ssd_kernel`` decides, the second an XLA
    compile switch (the port loops over its layers).

    ``attn_probs_fp32`` False keeps the plain ``sdpa``'s scores and
    probabilities in the compute dtype (bf16 halves each materialised
    score tensor) where True, the default, casts them to fp32;
    ``expand_kv`` repeats the kv heads to the query heads before the
    plain ``sdpa``'s scores (the reference's GSPMD hint for kv heads
    that do not divide the model axis). Both reach only the plain
    ``sdpa``, never a kernel: the cached kernel paths keep their kernels
    under ``expand_kv`` (``models.layers``), and the cross-attention
    keeps fp32 probabilities, as in the reference.

    ``remat`` recomputes each period's activations (the pattern's
    layers) in the backward pass instead of keeping them
    (``T.forward_aux``): ``remat_policy`` "full" keeps only the period's
    input, "dots" also the outputs of its matrix products (the
    reference's ``dots_saveable``)."""

    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0            # 0 -> d_model // n_heads
    norm: str = "rms"            # "rms" | "layer"
    activation: str = "swiglu"   # "swiglu" | "gelu"
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: Optional[float] = 10000.0
    pattern: Tuple[str, ...] = ("attn",)
    moe_positions: Tuple[int, ...] = ()      # pattern positions with MoE MLP
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    moe_impl: str = "capacity"               # "capacity" | "dense_mask"
    moe_capacity_factor: float = 1.25
    mamba_d_state: int = 128
    mamba_head_dim: int = 64
    mamba_expand: int = 2
    encoder: Optional[EncoderConfig] = None  # enc-dec (whisper)
    n_frontend_tokens: int = 0               # vision/audio stub tokens
    compute_dtype: str = "float32"
    use_flash: bool = False
    expand_kv: bool = False      # repeat kv heads to q heads in ``sdpa``
    attn_probs_fp32: bool = True  # False: bf16 scores and probabilities
    remat: bool = False
    remat_policy: str = "full"   # "full" | "dots" (save matmul outputs)

    def __post_init__(self):
        if self.n_layers % len(self.pattern):
            raise ValueError(f"{self.name}: {self.n_layers} layers is not "
                             f"a multiple of the pattern {self.pattern}")
        if self.norm not in ("rms", "layer"):
            raise ValueError(f"{self.name}: norm {self.norm!r} is not "
                             f"'rms' or 'layer'")
        if self.remat_policy not in ("full", "dots"):
            raise ValueError(f"{self.name}: remat_policy "
                             f"{self.remat_policy!r} is not 'full' or "
                             f"'dots'")

    @property
    def dhead(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def periods(self) -> int:
        return self.n_layers // len(self.pattern)

    def kind(self, layer: int) -> str:
        """The mixer of layer ``layer``: its position in the pattern."""
        return self.pattern[layer % len(self.pattern)]

    def is_moe(self, layer: int) -> bool:
        """Whether layer ``layer``'s MLP is a mixture of experts."""
        return bool(self.n_experts) and \
            layer % len(self.pattern) in self.moe_positions

    def moe_cfg(self):
        from repro_torch.models.moe import MoEConfig

        return MoEConfig(d_model=self.d_model, d_ff=self.d_ff,
                         n_experts=self.n_experts, top_k=self.top_k,
                         n_shared=self.n_shared_experts, impl=self.moe_impl,
                         capacity_factor=self.moe_capacity_factor)

    def mamba_cfg(self):
        from repro_torch.models.mamba import MambaConfig

        return MambaConfig(d_model=self.d_model, d_state=self.mamba_d_state,
                           head_dim=self.mamba_head_dim,
                           expand=self.mamba_expand)

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
    """The registry's module names (``ARCHS``), as the reference's
    ``list_archs``; ``canonical_id`` maps each to its CLI id."""
    return list(ARCHS)


def canonical_id(name: str) -> str:
    """The CLI id (a key of ``ALIASES``) of ``name``, which may be that
    id, its module's name (``list_archs``) or an alias of either;
    anything else comes back as it is."""
    for cli, mod in ALIASES.items():
        if mod == ALIASES.get(name, name).replace("-", "_").replace(".", "_"):
            return cli
    return name
