"""llama-3.2-vision-90b [vlm]: 100 layers, d_model 8192, 64 heads (GQA,
8 kv heads), d_ff 28672, vocab 128256; a gated cross-attention layer
every 5th layer [hf:meta-llama/Llama-3.2-11B-Vision]. The vision frontend
is stubbed: 1601 precomputed patch embeddings."""
from repro_torch.configs import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b", n_layers=100, d_model=8192, n_heads=64,
    n_kv_heads=8, d_ff=28672, vocab=128256,
    pattern=("cross", "attn", "attn", "attn", "attn"),
    n_frontend_tokens=1601, compute_dtype="bfloat16")

SMOKE = ModelConfig(
    name="llama-vision-smoke", n_layers=5, d_model=32, n_heads=4,
    n_kv_heads=2, d_ff=64, vocab=128,
    pattern=("cross", "attn", "attn", "attn", "attn"),
    n_frontend_tokens=9, compute_dtype="float32")
