"""llama4-maverick-400b-a17b [moe]: 48L d_model=5120 40H (GQA kv=8)
d_ff=8192 vocab=202048; dense and MoE layers alternate, the MoE a mixture
of 128 experts, top-1, plus one shared expert."""
from repro_torch.configs import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b", n_layers=48, d_model=5120, n_heads=40,
    n_kv_heads=8, d_ff=8192, vocab=202048,
    pattern=("attn", "attn"), moe_positions=(1,),
    n_experts=128, top_k=1, n_shared_experts=1, compute_dtype="bfloat16")

SMOKE = ModelConfig(
    name="llama4-maverick-smoke", n_layers=2, d_model=32, n_heads=4,
    n_kv_heads=2, d_ff=64, vocab=128, pattern=("attn", "attn"),
    moe_positions=(1,), n_experts=8, top_k=1, n_shared_experts=1,
    moe_impl="dense_mask", compute_dtype="float32")
