"""whisper-medium [audio]: encoder-decoder, the conv frontend stubbed.

24 + 24 layers, d_model 1024, 16 heads (MHA), d_ff 4096, vocab 51865,
LayerNorm, GELU, qkv biases, no RoPE (sinusoidal positions); the encoder
reads 1500 precomputed frames (30 s of audio) [arXiv:2212.04356]."""
from repro_torch.configs import EncoderConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium", n_layers=24, d_model=1024, n_heads=16,
    n_kv_heads=16, d_ff=4096, vocab=51865, norm="layer", activation="gelu",
    qkv_bias=True, rope_theta=None,
    encoder=EncoderConfig(n_layers=24, n_ctx=1500),
    n_frontend_tokens=1500, compute_dtype="bfloat16")

SMOKE = ModelConfig(
    name="whisper-medium-smoke", n_layers=2, d_model=32, n_heads=4,
    n_kv_heads=4, d_ff=64, vocab=128, norm="layer", activation="gelu",
    qkv_bias=True, rope_theta=None,
    encoder=EncoderConfig(n_layers=2, n_ctx=12),
    n_frontend_tokens=12, compute_dtype="float32")
