"""The served model's weights, made by the benchmark from ``--seed`` on
the device, in the tree the port's forward reads (``repro_torch``'s
``transformer.init_params`` layout: ``embed.embedding``, ``blocks[i]``
with ``ln1`` and ``attn`` or ``mamba``, then ``ln2`` and ``mlp`` or
``moe``, ``ln_f``, ``unembed.lm_head``).

Each layer's matrices are one standard-normal draw into one buffer in the
served dtype (a few large calls on the card, no fp32 copy), cut into
views and scaled by 1/sqrt(fan-in) in place; norm scales are drawn
uniform in [0.8, 1.2] so that a norm that forgets its scale shows. The
program and the reference read the same tensors; neither derives them.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

Tree = Dict[str, object]


def mamba_dims(m: dict) -> Tuple[int, int, int, int]:
    """(heads, head_dim, d_state, d_conv) of a config's Mamba-2 mixer."""
    heads = m["mamba_expand"] * m["d_model"] // m["mamba_head_dim"]
    return heads, m["mamba_head_dim"], m["mamba_d_state"], 4


def layer_kinds(m: dict) -> List[Tuple[str, bool]]:
    """(mixer, has a mixture of experts) of each layer."""
    pattern = m.get("pattern", ["attn"])
    moe = set(m.get("moe_positions", ()))
    return [(pattern[i % len(pattern)],
             bool(m.get("n_experts")) and i % len(pattern) in moe)
            for i in range(m["n_layers"])]


def _matrices(m: dict, kind: str, moe: bool) -> List[Tuple[tuple, str, float]]:
    """(path, shape, scale) of one layer's served-dtype leaves."""
    d, h, kvh = m["d_model"], m["n_heads"], m["n_kv_heads"]
    hd = m.get("head_dim") or d // h
    f = m["d_ff"]
    out = []
    if kind == "attn":
        out += [(("attn", "wq"), (d, h, hd), d), (("attn", "wk"), (d, kvh, hd), d),
                (("attn", "wv"), (d, kvh, hd), d),
                (("attn", "wo"), (h, hd, d), h * hd)]
    else:
        mh, p, n, k = mamba_dims(m)
        out += [(("mamba", "w_x"), (d, mh, p), d), (("mamba", "w_z"), (d, mh, p), d),
                (("mamba", "w_B"), (d, n), d), (("mamba", "w_C"), (d, n), d),
                (("mamba", "w_dt"), (d, mh), d),
                (("mamba", "conv_w"), (k, mh, p), 4.0),
                (("mamba", "w_ssm_out"), (mh, p, d), mh * p)]
    if moe:
        e = m["n_experts"]
        out += [(("moe", "expert_gate"), (e, d, f), d),
                (("moe", "expert_up"), (e, d, f), d),
                (("moe", "expert_down"), (e, f, d), f)]
    elif f:
        out += [(("mlp", "w_gate"), (d, f), d), (("mlp", "w_up"), (d, f), d),
                (("mlp", "w_down"), (f, d), f)]
    return [(path, shape, 1.0 / math.sqrt(fan)) for path, shape, fan in out]


@torch.no_grad()
def make(m: dict, seed: int, device, dtype: torch.dtype) -> Tree:
    """The weights of the model ``m`` (a config file's ``port_config``)
    from ``seed``: matrices in ``dtype``, norm scales, the router and the
    Mamba mixer's per-head constants in fp32."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    d = m["d_model"]
    f32 = dict(device=device, dtype=torch.float32)

    def scales(n):
        return torch.rand(n, generator=g, **f32).mul_(0.4).add_(0.8)

    def draw(leaves):
        total = sum(math.prod(s) for _, s, _ in leaves)
        buf = torch.randn(total, generator=g, device=device, dtype=dtype)
        out, at = [], 0
        for path, shape, scale in leaves:
            n = math.prod(shape)
            out.append((path, buf[at:at + n].view(shape).mul_(scale)))
            at += n
        return out

    blocks = []
    for kind, moe in layer_kinds(m):
        block: Tree = {"ln1": {"scale": scales(d)}}
        for (group, name), t in draw(_matrices(m, kind, moe)):
            block.setdefault(group, {})[name] = t
        if kind == "mamba":
            mh, p, _, _ = mamba_dims(m)
            block["mamba"].update(
                dt_bias=torch.zeros(mh, **f32),
                A_log=torch.log(torch.linspace(1.0, 16.0, mh, **f32)),
                D=torch.ones(mh, **f32), norm={"scale": scales(mh * p)})
        if moe:
            block["moe"]["router"] = torch.randn(
                (d, m["n_experts"]), generator=g, **f32).mul_(0.02)
        if moe or m["d_ff"]:
            block["ln2"] = {"scale": scales(d)}
        blocks.append(block)
    (_, emb), (_, head) = draw([(("embed",), (m["vocab"], d), 1.0),
                                (("unembed",), (d, m["vocab"]),
                                 1.0 / math.sqrt(d))])
    return {"embed": {"embedding": emb}, "blocks": blocks,
            "ln_f": {"scale": scales(d)}, "unembed": {"lm_head": head}}
