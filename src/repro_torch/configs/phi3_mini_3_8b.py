"""phi3-mini-3.8b [dense]: 32L d_model=3072 32H (MHA: kv=32) d_ff=8192
vocab=32064 — RoPE, SwiGLU, head_dim 96 (3072 / 32)."""
from repro_torch.configs import ModelConfig

CONFIG = ModelConfig(
    name="phi3-mini-3.8b", n_layers=32, d_model=3072, n_heads=32,
    n_kv_heads=32, d_ff=8192, vocab=32064, compute_dtype="bfloat16")

SMOKE = ModelConfig(
    name="phi3-mini-3.8b-smoke", n_layers=2, d_model=32, n_heads=4,
    n_kv_heads=4, d_ff=64, vocab=128, compute_dtype="float32")
