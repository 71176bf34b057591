"""jamba-v0.1-52b [hybrid]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536 — Mamba and attention at 7:1 (the attention layer at pattern
position 4), every other layer's MLP a mixture of 16 experts, top-2;
Mamba-2 heads of 64 with d_state 16 (128 SSM heads)."""
from repro_torch.configs import ModelConfig

_PATTERN = ("mamba", "mamba", "mamba", "mamba", "attn", "mamba", "mamba",
            "mamba")

CONFIG = ModelConfig(
    name="jamba-v0.1-52b", n_layers=32, d_model=4096, n_heads=32,
    n_kv_heads=8, d_ff=14336, vocab=65536, pattern=_PATTERN,
    moe_positions=(1, 3, 5, 7), n_experts=16, top_k=2,
    mamba_d_state=16, mamba_head_dim=64, mamba_expand=2,
    compute_dtype="bfloat16")

SMOKE = ModelConfig(
    name="jamba-smoke", n_layers=8, d_model=32, n_heads=4, n_kv_heads=2,
    d_ff=64, vocab=128, pattern=_PATTERN, moe_positions=(1, 3, 5, 7),
    n_experts=4, top_k=2, moe_impl="dense_mask",
    mamba_d_state=8, mamba_head_dim=8, mamba_expand=2,
    compute_dtype="float32")
