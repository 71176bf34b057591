"""A hybrid of Mamba-2 and attention layers with mixture-of-experts MLPs
(the Jamba period as the port's config states it) in plain fp32 PyTorch,
one sequence at a time, as a batch-1 prefill runs it.

* Attention layers: ``dense``'s causal GQA attention with half-split RoPE.
* Mamba layers, Mamba-2's SSD mixer (arXiv:2405.21060) with one B/C group
  for every head: x, z, B, C and dt projected from the normed input;
  a depthwise causal conv of width 4 and SiLU on x only; dt = softplus(.
  + dt_bias), the per-step decay exp(dt * -exp(A_log)); the state
  h_t = h_{t-1} * decay_t + (x_t * dt_t) B_t^T and y_t = h_t C_t, worked
  out chunk by chunk (the quadratic form inside a chunk, the carried
  state between chunks); then y + D * x, times SiLU(z), an RMSNorm over
  all heads' channels, and the output projection.
* Mixtures of experts: the fp32 router's softmax, the top-k experts by
  probability (ties to the lower expert), their weights renormalised; a
  SwiGLU expert's output weighted and summed. The prompt's rows are
  routed together, as its prefill routes them: each expert takes at most
  ceil(rows * k / experts * factor) (at least 4) of their choices, in
  token order, and drops the rest. Each later row (a decoded token) is
  routed alone and drops nothing: the rows a decode step shares with the
  other slots are not the reference's to know, so a served token whose
  step dropped one of its choices reads as a gap.
"""

from __future__ import annotations

import math
from typing import List

import torch
import torch.nn.functional as F

from portbench.reference.dense import (Quant, attention, fp8, mm,  # noqa: F401
                                       rmsnorm, rope, strict_fp32)

CHUNK = 64


def ssd(x, a_log, b, c, chunk: int = CHUNK):
    """y_t = sum over s <= t of (C_t . B_s) exp(sum a_log(s, t]) x_s, by
    chunks. x (L, h, p) already dt-scaled, a_log (L, h), b and c (L, n)."""
    L, h, p = x.shape
    n = b.shape[1]
    state = x.new_zeros(h, p, n)
    ys = []
    for s0 in range(0, L, chunk):
        xs, As = x[s0:s0 + chunk], a_log[s0:s0 + chunk]
        bs, cs = b[s0:s0 + chunk], c[s0:s0 + chunk]
        cum = torch.cumsum(As, dim=0)                            # (q, h)
        seg = cum[:, None, :] - cum[None, :, :]                  # (t, s, h)
        q = xs.shape[0]
        causal = torch.tril(torch.ones(q, q, dtype=torch.bool,
                                       device=x.device))
        decay = torch.where(causal[..., None], torch.exp(seg),
                            torch.zeros((), device=x.device))
        scores = (cs @ bs.T)[..., None] * decay                  # (t, s, h)
        y = torch.einsum("tsh,shp->thp", scores, xs)
        y = y + torch.einsum("tn,hpn,th->thp", cs, state, torch.exp(cum))
        tail = torch.exp(cum[-1][None, :] - cum)                 # (s, h)
        state = state * torch.exp(cum[-1])[:, None, None] + torch.einsum(
            "sh,shp,sn->hpn", tail, xs, bs)
        ys.append(y)
    return torch.cat(ys)


def mamba(w: dict, x, m: dict, eps: float, quant: Quant):
    """The SSD mixer on one normed sequence x (L, d)."""
    L, d = x.shape
    hp = w["w_x"].shape[1] * w["w_x"].shape[2]
    heads, p = w["w_x"].shape[1], w["w_x"].shape[2]
    xin = mm(x, w["w_x"].reshape(d, hp).float(), quant).reshape(L, heads, p)
    z = mm(x, w["w_z"].reshape(d, hp).float(), quant)
    b = mm(x, w["w_B"].float(), quant)
    c = mm(x, w["w_C"].float(), quant)
    dt = F.softplus(mm(x, w["w_dt"].float(), quant) + w["dt_bias"].float())
    k = w["conv_w"].shape[0]
    pad = torch.cat([xin.new_zeros(k - 1, heads, p), xin])
    conv = sum(pad[i:i + L] * w["conv_w"][i].float() for i in range(k))
    xin = F.silu(conv)
    a_log = dt * -torch.exp(w["A_log"].float())
    y = ssd(xin * dt[..., None], a_log, b, c)
    y = (y + xin * w["D"].float()[None, :, None]).reshape(L, hp)
    y = rmsnorm(y * F.silu(z), w["norm"]["scale"], eps)
    return mm(y, w["w_ssm_out"].reshape(hp, d).float(), quant)


def moe(w: dict, x, m: dict, quant: Quant, prompt: int):
    """Top-k experts over one sequence's rows x (t, d), its first
    ``prompt`` rows routed by capacity among themselves."""
    e, k = m["n_experts"], m["top_k"]
    probs = torch.softmax(x @ w["router"].float(), dim=-1)
    wts, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    wts, ids = wts[:, :k], ids[:, :k]
    wts = wts / wts.sum(dim=-1, keepdim=True)
    cap = max(math.ceil(prompt * k / e * m.get("moe_capacity_factor", 1.25)),
              4)
    out = torch.zeros_like(x)
    for j in range(e):
        tok, slot = (ids == j).nonzero(as_tuple=True)    # in token order
        keep = (tok >= prompt) | (torch.cumsum(tok < prompt, 0) <= cap)
        tok, slot = tok[keep], slot[keep]
        if not len(tok):
            continue
        g = mm(x[tok], w["expert_gate"][j].float(), quant)
        u = mm(x[tok], w["expert_up"][j].float(), quant)
        y = mm(F.silu(g) * u, w["expert_down"][j].float(), quant)
        out.index_add_(0, tok, y * wts[tok, slot][:, None])
    return out


@torch.no_grad()
def logits(weights: dict, cfg: dict, seqs: List[torch.Tensor],
           starts: List[int], quant: Quant = None) -> List[torch.Tensor]:
    """For each token sequence, the fp32 logits at positions ``start`` to
    the end: rows up to ``start`` are the prompt (a batch-1 prefill's
    routing), each later row a decoded token."""
    strict_fp32()
    m = cfg["port_config"]
    eps, theta = float(cfg["rms_norm_eps"]), float(m["rope_theta"])
    d, h, kvh = m["d_model"], m["n_heads"], m["n_kv_heads"]
    hd = m.get("head_dim") or d // h
    pattern, moe_at = m["pattern"], set(m.get("moe_positions", ()))
    out = []
    for seq, start in zip(seqs, starts):
        x = weights["embed"]["embedding"][seq.long()].float()
        L = x.shape[0]
        for i, block in enumerate(weights["blocks"]):
            hin = rmsnorm(x, block["ln1"]["scale"], eps)
            if pattern[i % len(pattern)] == "attn":
                a = block["attn"]
                q = rope(mm(hin, a["wq"].reshape(d, h * hd).float(), quant)
                         .reshape(L, h, hd), theta)
                kk = rope(mm(hin, a["wk"].reshape(d, kvh * hd).float(), quant)
                          .reshape(L, kvh, hd), theta)
                v = mm(hin, a["wv"].reshape(d, kvh * hd).float(),
                       quant).reshape(L, kvh, hd)
                x = x + mm(attention(q, kk, v, quant).reshape(L, h * hd),
                           a["wo"].reshape(h * hd, d).float(), quant)
            else:
                x = x + mamba(block["mamba"], hin, m, eps, quant)
            h2 = rmsnorm(x, block["ln2"]["scale"], eps)
            if m.get("n_experts") and i % len(pattern) in moe_at:
                x = x + moe(block["moe"], h2, m, quant, start + 1)
            else:
                mlp = block["mlp"]
                g = mm(h2, mlp["w_gate"].float(), quant)
                u = mm(h2, mlp["w_up"].float(), quant)
                x = x + mm(F.silu(g) * u, mlp["w_down"].float(), quant)
        out.append(mm(rmsnorm(x[start:], weights["ln_f"]["scale"], eps),
                      weights["unembed"]["lm_head"].float(), quant))
    return out
