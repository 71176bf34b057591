"""granite-3-8b [dense]: 40L d_model=4096 32H (GQA kv=8) d_ff=12800
vocab=49155, RMSNorm, SwiGLU, head_dim 128."""
from repro_torch.configs import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-8b", n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=12800, vocab=49155, rope_theta=10000.0, compute_dtype="bfloat16")

SMOKE = ModelConfig(
    name="granite-3-8b-smoke", n_layers=2, d_model=32, n_heads=4,
    n_kv_heads=2, d_ff=96, vocab=128, compute_dtype="float32")
