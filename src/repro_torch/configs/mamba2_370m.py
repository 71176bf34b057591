"""mamba2-370m [ssm]: 48L d_model=1024 (attention-free) vocab=50280,
d_state 128, head_dim 64, expand 2 (32 SSM heads) — SSD (state-space
duality) [arXiv:2405.21060]. d_ff=0: no separate MLP (the Mamba block
carries the gating)."""
from repro_torch.configs import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m", n_layers=48, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=0, vocab=50280, pattern=("mamba",),
    mamba_d_state=128, mamba_head_dim=64, mamba_expand=2,
    compute_dtype="bfloat16")

SMOKE = ModelConfig(
    name="mamba2-370m-smoke", n_layers=2, d_model=32, n_heads=4,
    n_kv_heads=4, d_ff=0, vocab=128, pattern=("mamba",),
    mamba_d_state=8, mamba_head_dim=8, mamba_expand=2,
    compute_dtype="float32")
