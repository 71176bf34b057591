"""dbrx-132b [moe]: 40L d_model=6144 48H (GQA kv=8) d_ff=10752
vocab=100352, every layer's MLP a mixture of 16 experts, top-4, capacity
routing (the smoke config routes by dense mask)."""
from repro_torch.configs import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b", n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=10752, vocab=100352, pattern=("attn",), moe_positions=(0,),
    n_experts=16, top_k=4, compute_dtype="bfloat16")

SMOKE = ModelConfig(
    name="dbrx-132b-smoke", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
    d_ff=64, vocab=128, pattern=("attn",), moe_positions=(0,),
    n_experts=4, top_k=2, moe_impl="dense_mask", compute_dtype="float32")
