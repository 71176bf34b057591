"""qwen2-0.5b [dense]: 24L d_model=896 14H (GQA kv=2) d_ff=4864
vocab=151936 — GQA, QKV bias, head_dim 64."""
from repro_torch.configs import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b", n_layers=24, d_model=896, n_heads=14, n_kv_heads=2,
    d_ff=4864, vocab=151936, qkv_bias=True, rope_theta=1e6,
    compute_dtype="bfloat16")

SMOKE = ModelConfig(
    name="qwen2-0.5b-smoke", n_layers=2, d_model=28, n_heads=7, n_kv_heads=1,
    d_ff=64, vocab=128, qkv_bias=True, compute_dtype="float32")
