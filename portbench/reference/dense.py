"""A dense GQA decoder (the granite family as the port runs it) in plain
fp32 PyTorch: pre-norm blocks of RMSNorm (eps from the config file),
causal attention with half-split RoPE and grouped kv heads (query head i
reads kv head i // (heads / kv heads)), softmax over q.k / sqrt(head_dim),
a SwiGLU MLP, a final RMSNorm and an untied unembedding.

``logits`` runs whole sequences, teacher-forced on the served tokens, and
returns the logits at the positions asked for. ``quant`` rounds every
matrix product's two inputs first (the control's lower precision,
``fp8``); None keeps fp32.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional

import torch

Quant = Optional[Callable[[torch.Tensor], torch.Tensor]]

FP8_MAX = 448.0


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under one per-tensor scale (its largest
    magnitude to the format's largest), back in fp32."""
    scale = x.abs().amax().clamp(min=1e-12) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def strict_fp32() -> None:
    """fp32 products in fp32: no TF32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def mm(a: torch.Tensor, b: torch.Tensor, quant: Quant) -> torch.Tensor:
    if quant is not None:
        a, b = quant(a), quant(b)
    return a @ b


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * \
        scale.float()


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Half-split rotary embedding of x (L, heads, d) at positions 0..L-1."""
    L, _, d = x.shape
    half = d // 2
    freqs = 1.0 / theta ** (torch.arange(half, dtype=torch.float32,
                                         device=x.device) / half)
    ang = torch.arange(L, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v, quant: Quant, block: int = 1024) -> torch.Tensor:
    """Causal softmax attention, q (L, h, d), k and v (L, kvh, d), in
    blocks of query rows."""
    L, h, d = q.shape
    group = h // k.shape[1]
    k = k.repeat_interleave(group, dim=1).transpose(0, 1)      # (h, L, d)
    v = v.repeat_interleave(group, dim=1).transpose(0, 1)
    out = torch.empty_like(q)
    for s0 in range(0, L, block):
        s1 = min(L, s0 + block)
        qb = q[s0:s1].transpose(0, 1)                          # (h, b, d)
        scores = mm(qb, k[:, :s1].transpose(1, 2), quant) / math.sqrt(d)
        rows = torch.arange(s0, s1, device=q.device)[:, None]
        cols = torch.arange(s1, device=q.device)[None, :]
        scores = scores.masked_fill(cols > rows, float("-inf"))
        probs = torch.softmax(scores, dim=-1)
        out[s0:s1] = mm(probs, v[:, :s1], quant).transpose(0, 1)
    return out


@torch.no_grad()
def logits(weights: dict, cfg: dict, seqs: List[torch.Tensor],
           starts: List[int], quant: Quant = None) -> List[torch.Tensor]:
    """For each token sequence (1-D, on the weights' device), the fp32
    logits at positions ``start`` to the end. ``cfg``: the config file
    (``port_config`` for the shapes, ``rms_norm_eps``, ``rope_theta``).
    Each layer's weights are cast to fp32 once for all sequences."""
    strict_fp32()
    m = cfg["port_config"]
    eps, theta = float(cfg["rms_norm_eps"]), float(m["rope_theta"])
    d, h, kvh = m["d_model"], m["n_heads"], m["n_kv_heads"]
    hd = m.get("head_dim") or d // h
    emb = weights["embed"]["embedding"]
    xs = [emb[s.long()].float() for s in seqs]
    for block in weights["blocks"]:
        a, mlp = block["attn"], block["mlp"]
        wqkv = torch.cat([a["wq"].reshape(d, h * hd), a["wk"].reshape(d, kvh * hd),
                          a["wv"].reshape(d, kvh * hd)], dim=1).float()
        wo = a["wo"].reshape(h * hd, d).float()
        wgu = torch.cat([mlp["w_gate"], mlp["w_up"]], dim=1).float()
        wd = mlp["w_down"].float()
        for i, x in enumerate(xs):
            L = x.shape[0]
            qkv = mm(rmsnorm(x, block["ln1"]["scale"], eps), wqkv, quant)
            q = rope(qkv[:, :h * hd].reshape(L, h, hd), theta)
            k = rope(qkv[:, h * hd:(h + kvh) * hd].reshape(L, kvh, hd), theta)
            v = qkv[:, (h + kvh) * hd:].reshape(L, kvh, hd)
            x = x + mm(attention(q, k, v, quant).reshape(L, h * hd), wo, quant)
            gu = mm(rmsnorm(x, block["ln2"]["scale"], eps), wgu, quant)
            g, u = gu.chunk(2, dim=1)
            xs[i] = x + mm(torch.nn.functional.silu(g) * u, wd, quant)
        del wqkv, wo, wgu, wd
    head = weights["unembed"]["lm_head"].float()
    return [mm(rmsnorm(x[s:], weights["ln_f"]["scale"], eps), head, quant)
            for x, s in zip(xs, starts)]
