"""Published peaks of the card, dense rates without sparsity (NVIDIA's
data sheet for the H100 SXM at its full 700 W power limit). A card set
below 700 W runs slower under load: a run prints its power limit beside
every share of these peaks."""

from __future__ import annotations

H100_SXM = {
    "bf16_flops": 989e12,        # FLOP/s, tensor cores
    "fp8_flops": 1979e12,
    "tf32_flops": 495e12,
    "fp32_flops": 67e12,         # outside the tensor cores
    "hbm_bytes": 3.35e12,        # B/s
    "hbm_capacity": 80e9,        # B
    "power_limit_w": 700.0,
}


def least_time(nbytes: float, flops: float) -> float:
    """The least time the card could take in bf16: the larger of the
    bytes over the memory bandwidth and the FLOPs over the compute peak."""
    return max(nbytes / H100_SXM["hbm_bytes"], flops / H100_SXM["bf16_flops"])
