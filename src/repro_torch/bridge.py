"""Carry the reference's parameters across, through numpy.

``params_from_jax`` takes the output of ``repro.models.transformer
.init_params`` with every leaf converted to a numpy array (the caller does
that, e.g. ``jax.tree.map(np.asarray, params)``) and returns the port's
parameter dict. This module imports neither JAX nor ``repro``.

The reference stacks each pattern position's parameters over periods
(``_stack_init``: leading dim = n_layers for a one-kind pattern); here
that dim is unstacked into one dict per layer. The ported patterns are
the dense ``("attn",)`` and the Mamba-2 ``("mamba",)``. Weight layouts are
kept as they are (``wq``/``wk``/``wv`` (d, h, hd), ``wo`` (h, hd, d),
``w_x``/``w_z`` (d, h, p), ``w_ssm_out`` (h, p, d)).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import ModelConfig

# Leaves kept in fp32 whatever the compute dtype (the reference applies
# them in fp32 or casts them at use).
FP32_LEAVES = {"scale", "b_q", "b_k", "b_v", "b_up", "dt_bias", "A_log", "D"}
PORTED_PATTERNS = (("attn",), ("mamba",))


def params_from_jax(np_params: Dict[str, Any], cfg: ModelConfig,
                    device=None, dtype=None) -> Dict[str, Any]:
    device = resolve_device(device)
    dtype = dtype or cfg.dtype

    def leaf(name, a):
        want = torch.float32 if name in FP32_LEAVES else dtype
        # np.array copies: the arrays JAX hands out are read-only.
        return torch.from_numpy(np.array(a)).to(device=device, dtype=want)

    def convert(tree, period=None):
        out = {}
        for name, v in tree.items():
            if isinstance(v, dict):
                out[name] = convert(v, period)
            else:
                out[name] = leaf(name, v if period is None else v[period])
        return out

    blocks_np = np_params["blocks"]
    if tuple(cfg.pattern) not in PORTED_PATTERNS or len(blocks_np) != 1:
        raise ValueError(f"pattern {cfg.pattern} is not ported; ported: "
                         f"{PORTED_PATTERNS}")
    stacked = blocks_np[0]
    periods = np.asarray(stacked["ln1"]["scale"]).shape[0]
    if periods != cfg.n_layers:
        raise ValueError(f"{periods} stacked layers, config has "
                         f"{cfg.n_layers}")
    return {
        "embed": convert(np_params["embed"]),
        "blocks": [convert(stacked, period=i) for i in range(periods)],
        "ln_f": convert(np_params["ln_f"]),
        "unembed": convert(np_params["unembed"]),
    }
