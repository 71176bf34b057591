"""Carry the reference's parameters across, through numpy.

``params_from_jax`` takes the output of ``repro.models.transformer
.init_params`` with every leaf converted to a numpy array (the caller does
that, e.g. ``jax.tree.map(np.asarray, params)``) and returns the port's
parameter dict. This module imports neither JAX nor ``repro``.

The reference stacks each pattern position's parameters over periods
(``_stack_init``: ``blocks[pos]`` has a leading dim of ``periods``); here
they are unstacked into one dict per layer, layer i being pattern position
``i % P``, period ``i // P`` (P the pattern's length). Any pattern of
``"attn"``, ``"cross"`` and ``"mamba"`` layers is carried, with dense or
mixture-of-experts MLPs, and the encoder of an encoder-decoder (the
reference's ``encoder.blocks[0]``, stacked over the encoder's layers,
becomes one dict a layer). Weight layouts are kept as they are
(``wq``/``wk``/``wv`` (d, h, hd), ``wo`` (h, hd, d), ``w_x``/``w_z``
(d, h, p), ``w_ssm_out`` (h, p, d), ``expert_gate``/``expert_up``
(e, d, f), ``expert_down`` (e, f, d)).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import ModelConfig

# Leaves kept in fp32 whatever the compute dtype (the reference applies
# them in fp32 or casts them at use).
FP32_LEAVES = {"scale", "bias", "b_q", "b_k", "b_v", "b_up", "dt_bias",
               "A_log", "D", "router", "gate"}
PORTED_KINDS = ("attn", "cross", "mamba")


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
    if any(k not in PORTED_KINDS for k in cfg.pattern):
        raise ValueError(f"pattern {cfg.pattern} is not ported; ported "
                         f"layer kinds: {PORTED_KINDS}")
    n_pos = len(cfg.pattern)
    if len(blocks_np) != n_pos:
        raise ValueError(f"{len(blocks_np)} stacked pattern positions, the "
                         f"config's pattern {cfg.pattern} has {n_pos}")
    for pos, stacked in enumerate(blocks_np):
        periods = np.asarray(stacked["ln1"]["scale"]).shape[0]
        if periods != cfg.periods:
            raise ValueError(f"position {pos}: {periods} stacked periods, "
                             f"config has {cfg.periods}")
    out = {
        "embed": convert(np_params["embed"]),
        "blocks": [convert(blocks_np[i % n_pos], period=i // n_pos)
                   for i in range(cfg.n_layers)],
        "ln_f": convert(np_params["ln_f"]),
        "unembed": convert(np_params["unembed"]),
    }
    if ("encoder" in np_params) != (cfg.encoder is not None):
        raise ValueError(f"{cfg.name}: the parameters and the config "
                         f"disagree on having an encoder")
    if cfg.encoder is not None:
        (enc_np,) = np_params["encoder"]["blocks"]
        out["encoder"] = {
            "blocks": [convert(enc_np, period=i)
                       for i in range(cfg.encoder.n_layers)],
            "ln_f": convert(np_params["encoder"]["ln_f"])}
    return out
