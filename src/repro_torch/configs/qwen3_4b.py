"""qwen3-4b [dense]: 36L d_model=2560 32H (GQA kv=8) d_ff=9728
vocab=151936 — qk_norm, GQA. head_dim is d_model / n_heads = 80, as in
the reference configuration."""
from repro_torch.configs import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-4b", n_layers=36, d_model=2560, n_heads=32, n_kv_heads=8,
    d_ff=9728, vocab=151936, qk_norm=True, rope_theta=1e6,
    compute_dtype="bfloat16")

SMOKE = ModelConfig(
    name="qwen3-4b-smoke", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
    d_ff=64, vocab=128, qk_norm=True, compute_dtype="float32")
