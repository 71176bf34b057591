"""Transformer stacks (port of ``repro/models/transformer.py``): patterns
of attention, cross-attention and Mamba-2 layers with dense or
mixture-of-experts MLPs, and the encoder of an encoder-decoder; a Python
loop over layers in place of the reference's ``lax.scan`` over stacked
periods.

Parameters: {"embed": {"embedding"}, "blocks": [per-layer dict, ...],
"ln_f", "unembed": {"lm_head"}} and, for a config with an encoder,
"encoder": {"blocks": [per-layer dict, ...], "ln_f"}. Each decoder layer
holds "ln1" and its mixer, "attn" or "mamba" (``cfg.kind(i)``); a
``"cross"`` layer holds "attn", then "ln_x" and "xattn" (attention
weights and a scalar fp32 "gate"); then, when ``d_ff > 0``, "ln2" and
"mlp", or "moe" where ``cfg.is_moe(i)``. An encoder layer holds "ln1",
"attn", "ln2" and "mlp". A norm is {"scale"} (RMSNorm) or {"scale",
"bias"} (LayerNorm). Leaf names are the reference's.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.utils.checkpoint as checkpoint

from repro_torch import resolve_device
from repro_torch.configs import ModelConfig
from repro_torch.dist import sharding
from repro_torch.models import layers, mamba, moe
from repro_torch.train import dist as train_dist
from repro_torch.tree import tree_leaves

Params = Dict[str, Any]


def attn_cfg(cfg: ModelConfig, causal: bool = True) -> layers.AttnConfig:
    return layers.AttnConfig(
        d_model=cfg.d_model, n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads, head_dim=cfg.dhead,
        qk_norm=cfg.qk_norm, qkv_bias=cfg.qkv_bias,
        rope_theta=cfg.rope_theta, causal=causal,
        expand_kv=cfg.expand_kv, probs_fp32=cfg.attn_probs_fp32)


def mlp_cfg(cfg: ModelConfig) -> layers.MLPConfig:
    return layers.MLPConfig(cfg.d_model, cfg.d_ff, cfg.activation)


# ----------------------------------------------------------------------------
# Initialisation
# ----------------------------------------------------------------------------

def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device=None, dtype: Optional[torch.dtype] = None) -> Params:
    """Random weights from the reference's distributions (``layers._init``:
    a standard normal times 1/sqrt(fan_in), 1.0 for the embedding, zeros
    for biases and the cross-attention's gate, ones for norm scales;
    ``moe.moe_init`` for a mixture of experts), drawn with ``generator``.

    Matmul weights and the embedding are stored in ``dtype`` (default: the
    config's compute dtype); norm scales and biases and the gate in fp32.
    ``generator`` must live on ``device``; None seeds a fresh one with 0.
    On the ``meta`` device (``param_shapes``) no value is drawn."""
    device = torch.device("meta") if str(device) == "meta" \
        else resolve_device(device)
    dtype = dtype or cfg.dtype
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)

    def normal(shape, scale=None):
        scale = scale if scale is not None else 1.0 / math.sqrt(shape[0])
        w = torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32)
        return (w * scale).to(dtype)

    def zeros(*shape):
        return torch.zeros(shape, device=device, dtype=torch.float32)

    d, h, kvh, hd, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.dhead,
                        cfg.d_ff)

    def norm():
        p = {"scale": torch.ones(d, device=device, dtype=torch.float32)}
        if cfg.norm == "layer":
            p["bias"] = zeros(d)
        return p

    def attention():
        attn = {"wq": normal((d, h, hd)), "wk": normal((d, kvh, hd)),
                "wv": normal((d, kvh, hd)),
                "wo": normal((h, hd, d), scale=1.0 / math.sqrt(h * hd))}
        if cfg.qkv_bias:
            for name, heads in (("b_q", h), ("b_k", kvh), ("b_v", kvh)):
                attn[name] = zeros(heads, hd)
        if cfg.qk_norm:
            attn["q_norm"], attn["k_norm"] = (
                {"scale": torch.ones(hd, device=device)} for _ in range(2))
        return attn

    def mlp():
        if cfg.activation == "swiglu":
            return {"w_gate": normal((d, f)), "w_up": normal((d, f)),
                    "w_down": normal((f, d), scale=1.0 / math.sqrt(f))}
        return {"w_up": normal((d, f)), "b_up": zeros(f),
                "w_down": normal((f, d), scale=1.0 / math.sqrt(f))}

    blocks = []
    for i in range(cfg.n_layers):
        block = {"ln1": norm()}
        kind = cfg.kind(i)
        if kind in ("attn", "cross"):
            block["attn"] = attention()
        elif kind == "mamba":
            block["mamba"] = mamba.mamba_init(generator, cfg.mamba_cfg(),
                                              device, dtype)
        else:
            raise ValueError(f"layer kind {kind!r} is not ported")
        if kind == "cross":
            block["ln_x"] = norm()
            block["xattn"] = dict(attention(), gate=zeros())
        if f > 0 and cfg.is_moe(i):
            block["ln2"] = norm()
            block["moe"] = moe.moe_init(generator, cfg.moe_cfg(), device,
                                        dtype)
        elif f > 0:
            block["ln2"], block["mlp"] = norm(), mlp()
        blocks.append(block)
    params = {"embed": {"embedding": normal((cfg.vocab, d), scale=1.0)},
              "blocks": blocks, "ln_f": norm(),
              "unembed": {"lm_head": normal((d, cfg.vocab))}}
    if cfg.encoder is not None:
        params["encoder"] = {
            "blocks": [{"ln1": norm(), "attn": attention(), "ln2": norm(),
                        "mlp": mlp()}
                       for _ in range(cfg.encoder.n_layers)],
            "ln_f": norm()}
    return params


def param_shapes(cfg: ModelConfig) -> Params:
    """``init_params``'s tree as fp32 meta tensors: every leaf's global
    shape, with no memory allocated (what the sharding rules read)."""
    return init_params(cfg, torch.Generator(), device="meta",
                       dtype=torch.float32)


def tree_param_count(params: Params) -> int:
    """Elements in a parameter tree's leaves (``param_count`` counts the
    same from a configuration, as the reference's does)."""
    return sum(t.numel() for t in tree_leaves(params))


def active_param_count(cfg: ModelConfig) -> int:
    """Parameters a token reads, from the configuration alone (no weights
    are made): every parameter ``init_params`` draws, less the experts a
    token is not routed to (a mixture of experts reads its router, its
    top-k experts and its shared ones), as the reference counts. The
    serving cost models price the weight stream with it
    (``serve.spec.rechoose_k``, ``telemetry.drift_report``)."""
    return param_count(cfg, active=True)


def param_count(cfg: ModelConfig, active: bool = False) -> int:
    """Parameters ``init_params`` draws for ``cfg``, from the
    configuration alone (the reference's ``param_count``); ``active``
    counts only the top-k of each mixture's experts."""
    d, h, kvh, hd, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.dhead,
                        cfg.d_ff)
    norm = 2 * d if cfg.norm == "layer" else d
    attn = d * (h + 2 * kvh) * hd + h * hd * d
    attn += (h + 2 * kvh) * hd if cfg.qkv_bias else 0
    attn += 2 * hd if cfg.qk_norm else 0
    mlp = 3 * d * f if cfg.activation == "swiglu" else 2 * d * f + f
    total = 2 * cfg.vocab * d + norm                  # embed, unembed, ln_f
    for i in range(cfg.n_layers):
        total += norm                                  # ln1
        kind = cfg.kind(i)
        if kind in ("attn", "cross"):
            total += attn
        else:
            m = cfg.mamba_cfg()
            hm, p, n = m.n_heads, m.head_dim, m.d_state
            total += (2 * d * hm * p + 2 * d * n + d * hm + 3 * hm
                      + m.d_conv * hm * p + hm * p + hm * p * d)
        if kind == "cross":
            total += norm + attn + 1                   # ln_x, xattn, gate
        if f > 0 and cfg.is_moe(i):
            e = cfg.top_k if active else cfg.n_experts
            total += norm + d * cfg.n_experts + 3 * d * f * (
                e + cfg.n_shared_experts)
        elif f > 0:
            total += norm + mlp
    if cfg.encoder is not None:
        total += cfg.encoder.n_layers * (2 * norm + attn + mlp) + norm
    return total


def n_attention_layers(cfg: ModelConfig) -> int:
    """Decoder layers with self-attention (and so a K/V cache): the
    ``"attn"`` and the ``"cross"`` layers."""
    return sum(cfg.kind(i) in ("attn", "cross") for i in range(cfg.n_layers))


def model_flops(cfg: ModelConfig, batch: int, seq: int, mode: str = "train",
                cache_len: int = 0) -> float:
    """MODEL_FLOPS, the reference's count: 2 * active parameters per token
    for inference (6 for training), plus the attention term 4 * tokens *
    ctx * heads * head_dim per attention layer, ctx the cache length when
    decoding and half the sequence for a causal prefill or training."""
    tokens = batch * seq
    fwd_bwd = 3.0 if mode == "train" else 1.0
    total = 2.0 * fwd_bwd * active_param_count(cfg) * tokens
    ctx = cache_len if cache_len else seq / 2.0
    return total + fwd_bwd * 4.0 * tokens * ctx * cfg.n_heads * cfg.dhead \
        * n_attention_layers(cfg)


# ----------------------------------------------------------------------------
# Forward
# ----------------------------------------------------------------------------

def _layer_apply(params: Params, cfg: ModelConfig, kind: str, x,
                 cache=None, cross_kv=None, ssd_kernel: bool = True,
                 writes=None):
    """One pre-norm block: the mixer, then (a ``"cross"`` layer) the gated
    cross-attention to ``cross_kv``, then the MLP (dense or a mixture of
    experts) if it has one, each with a residual. Returns (x, new cache,
    aux): ``aux`` is the mixture's load-balancing loss, 0 for a dense
    MLP. ``ssd_kernel`` False runs a Mamba mixer through the plain
    chunked scan (``mamba.mamba_apply``'s ``use_kernel``); ``writes``
    is a paged cache's ``layers.paged_writes`` for the step."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = layers.norm(cfg.norm, params["ln1"], x)
    if kind == "mamba":
        mix, new_cache = mamba.mamba_apply(params["mamba"], cfg.mamba_cfg(),
                                           h, cache=cache,
                                           use_kernel=ssd_kernel)
    else:
        mix, new_cache = layers.attention_apply(
            params["attn"], attn_cfg(cfg), h, cache=cache,
            use_flash=cfg.use_flash, writes=writes)
    x = x + mix
    if kind == "cross":
        hx = layers.norm(cfg.norm, params["ln_x"], x)
        x = x + layers.cross_attention_apply(
            params["xattn"], attn_cfg(cfg, causal=False), hx,
            cross_kv.to(x.dtype))
    if "moe" in params:
        h2 = layers.norm(cfg.norm, params["ln2"], x)
        y, aux = moe.moe_apply(params["moe"], cfg.moe_cfg(), h2)
        x = x + y
    elif "mlp" in params:
        h2 = layers.norm(cfg.norm, params["ln2"], x)
        x = x + layers.mlp_apply(params["mlp"], mlp_cfg(cfg), h2)
    return x, new_cache, aux


def encode(params: Params, cfg: ModelConfig, frontend_embeds):
    """The encoder over the frontend's embeddings (b, n, d_model): the
    fp32 sinusoid table added, then blocks of non-causal, RoPE-less
    attention through the plain ``sdpa`` and the dense MLP, then the
    encoder's final norm. Returns (b, n, d_model) in the compute dtype.
    Under a train step's model axis the blocks split as the decoder's
    cache-less ones (``layers.attention_apply``, ``layers.mlp_apply``)."""
    x = frontend_embeds.to(cfg.dtype)
    pos = layers.sinusoidal_positions(x.shape[1], cfg.d_model, x.device)
    x = x + pos[None].to(x.dtype)
    acfg = dataclasses.replace(attn_cfg(cfg, causal=False), rope_theta=None)
    for block in params["encoder"]["blocks"]:
        h = layers.norm(cfg.norm, block["ln1"], x)
        x = x + layers.attention_apply(block["attn"], acfg, h)[0]
        h2 = layers.norm(cfg.norm, block["ln2"], x)
        x = x + layers.mlp_apply(block["mlp"], mlp_cfg(cfg), h2)
    return layers.norm(cfg.norm, params["encoder"]["ln_f"], x)


def cross_source(params: Params, cfg: ModelConfig, frontend_embeds):
    """What the cross layers attend to, or None where no layer reads it:
    the encoder's output for a config with an encoder, else the frontend's
    embeddings in the compute dtype. whisper-medium's pattern has no cross
    layer, so its encoder is not run (the reference runs it and drops the
    output): its logits do not depend on ``frontend_embeds``."""
    if "cross" not in cfg.pattern:
        return None
    if frontend_embeds is None:
        raise ValueError(f"{cfg.name}: the cross layers need "
                         f"frontend_embeds or cross_kv")
    if cfg.encoder is not None:
        return encode(params, cfg, frontend_embeds)
    return frontend_embeds.to(cfg.dtype)


def sinusoid_at(positions: torch.Tensor, d: int) -> torch.Tensor:
    """(..., d) sinusoidal positions computed in fp32 on the fly (the
    decoder's recipe, not the encoder's float64 table), for integer
    ``positions`` of any shape. The fp32 divisors 10000^(2i/d) are
    rounded once from float64: fp32 ``pow`` differs by an ulp between
    libraries (XLA's on the CPU is the rounded value at d 1024, torch's
    is not), which moves a sine at position 1500 by 3e-5."""
    dim = torch.arange(d // 2, dtype=torch.float32, device=positions.device)
    div = torch.pow(10000.0, (2 * dim / d).double()).float()
    angle = positions[..., None].float() / div
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)


def forward(params: Params, cfg: ModelConfig, tokens,
            caches: Optional[List[Params]] = None, frontend_embeds=None,
            cross_kv=None
            ) -> Tuple[torch.Tensor, Optional[List[Params]]]:
    """tokens (b, s) -> (logits (b, s, vocab), new caches or None): the
    serving forward, ``forward_aux`` without its aux loss.

    Without ``caches`` attention is causal over the whole sequence: the
    full-sequence kernel under ``cfg.use_flash``, the plain ``sdpa``
    otherwise. With ``caches`` (``init_caches`` or ``init_paged_caches``)
    the new K/V rows are written into each attention layer's cache in
    place, each Mamba layer returns its new conv/SSM state, and every
    returned cache has its write position advanced by s.

    The cross layers attend to ``cross_kv`` (b, n, d_model) where it is
    given (serving computes it once, ``cross_source``, so that decode
    steps do not run the encoder again), else to
    ``cross_source(frontend_embeds)``. A config without ``rope_theta``
    adds sinusoidal positions to the embeddings, starting at each slot's
    own cache position (the reference starts every slot at slot 0's)."""
    logits, new_caches, _ = forward_aux(params, cfg, tokens, caches=caches,
                                        frontend_embeds=frontend_embeds,
                                        cross_kv=cross_kv)
    return logits, new_caches


def forward_aux(params: Params, cfg: ModelConfig, tokens,
                caches: Optional[List[Params]] = None, frontend_embeds=None,
                cross_kv=None, ssd_kernel: bool = True
                ) -> Tuple[torch.Tensor, Optional[List[Params]],
                           torch.Tensor]:
    """``forward`` that also returns the mixtures' load-balancing loss
    summed over layers (fp32, 0 without experts), as the reference's
    ``forward`` does. ``ssd_kernel`` False runs the Mamba layers through
    the plain chunked scan: the training step's choice, since the scan
    kernel has no backward.

    Inside a train step on a mesh (``train.dist.use_mesh``) every layer
    splits over its model axis: the attention, cross-attention, encoder
    blocks and MLPs by heads and ``mlp`` (``models.layers``), the
    mixtures by experts (``models.moe``), the Mamba mixers by
    ``ssm_heads`` (``models.mamba``); over the data axis the mixtures
    route over the whole batch. With ``cfg.remat``, a forward that
    builds a gradient (no caches, grad mode on) checkpoints each period
    (``_remat_periods``)."""
    x = layers.embed(params["embed"], tokens, cfg.dtype, vocab=cfg.vocab)
    if cross_kv is not None:
        cross_kv = cross_kv.to(cfg.dtype)
    else:
        cross_kv = cross_source(params, cfg, frontend_embeds)
    if cfg.rope_theta is None:
        pos = torch.arange(tokens.shape[1], device=x.device)
        if caches is not None:
            idx = caches[0]["index"].long()
            pos = pos + (idx[:, None] if idx.dim() == 1 else idx)
        x = x + sinusoid_at(pos, cfg.d_model).to(x.dtype)
    new_caches = [] if caches is not None else None
    # A paged pool's table and write positions are every layer's: where
    # the step's rows land is worked out once.
    writes = layers.paged_writes(caches[0], tokens.shape[1]) \
        if caches is not None and "kp" in caches[0] else None
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.remat and caches is None and torch.is_grad_enabled():
        x, aux = _remat_periods(params, cfg, x, cross_kv, ssd_kernel)
    else:
        for i, block in enumerate(params["blocks"]):
            cache = caches[i] if caches is not None else None
            x, nc, a = _layer_apply(block, cfg, cfg.kind(i), x, cache=cache,
                                    cross_kv=cross_kv,
                                    ssd_kernel=ssd_kernel, writes=writes)
            aux = aux + a
            if caches is not None:
                new_caches.append(nc)
    x = layers.norm(cfg.norm, params["ln_f"], x)
    return (layers.unembed(params["unembed"], x, vocab=cfg.vocab),
            new_caches, aux)


def _dots_policy(ctx, op, *args, **kwargs):
    """``remat_policy="dots"``: keep the matrix products' outputs (the
    reference's ``dots_saveable``), recompute the rest."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
              torch.ops.aten.addmm.default):
        return checkpoint.CheckpointPolicy.MUST_SAVE
    return checkpoint.CheckpointPolicy.PREFER_RECOMPUTE


def _remat_periods(params: Params, cfg: ModelConfig, x, cross_kv,
                   ssd_kernel: bool):
    """The decoder's layers with each period (the pattern's layers)
    checkpointed (``torch.utils.checkpoint``, non-reentrant): the backward
    runs the period again, collectives included, from its saved input
    (and, under "dots", its matrix products' outputs). The recompute
    may run on the autograd engine's thread, so each period installs the
    train step's mesh and the serving ruleset that were active around it.
    Returns (x, the summed aux loss)."""
    tm, rs = train_dist.active(), sharding.current_ruleset()
    n_pos = len(cfg.pattern)
    context = (functools.partial(
        checkpoint.create_selective_checkpoint_contexts, _dots_policy)
        if cfg.remat_policy == "dots" else checkpoint.noop_context_fn)

    def period(x, start: int):
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        with train_dist.use_mesh(tm), sharding.use_ruleset(rs):
            for i in range(start, start + n_pos):
                x, _, a = _layer_apply(params["blocks"][i], cfg, cfg.kind(i),
                                       x, cross_kv=cross_kv,
                                       ssd_kernel=ssd_kernel)
                aux = aux + a
        return x, aux

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for start in range(0, cfg.n_layers, n_pos):
        x, a = checkpoint.checkpoint(period, x, start, use_reentrant=False,
                                     context_fn=context)
        aux = aux + a
    return x, aux


# The logical dims of each contiguous cache leaf (the reference's dry-run
# specs): each goes through ``Ruleset.spec``, so a dim that does not
# divide its axes replicates.
_CACHE_DIMS = {"k": ("batch", "cache_seq", "kv_heads", None),
               "v": ("batch", "cache_seq", "kv_heads", None),
               "conv": ("batch", None, "ssm_heads", None),
               "ssm": ("batch", "ssm_heads", None, None),
               "index": ("batch",)}


def cache_spec(ruleset: sharding.Ruleset, kind: str, shape) -> tuple:
    """The spec of a contiguous cache leaf (``_CACHE_DIMS``) under
    ``ruleset``."""
    return ruleset.spec(_CACHE_DIMS[kind][:len(shape)], tuple(shape))


def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                per_slot_index: bool = False, device=None,
                dtype: Optional[torch.dtype] = None,
                ruleset: Optional[sharding.Ruleset] = None) -> List[Params]:
    """Contiguous decode caches, one per layer, in ``dtype`` (default:
    the compute dtype; int8 is the reference's dry-run knob, written with
    saturation and read back in the compute dtype, ``layers.cast_to``):

    * attention (``"attn"`` and ``"cross"`` layers: the cross-attention
      keeps no cache): ``k``/``v`` (batch, max_len, kvh, dhead);
    * mamba: ``conv`` (batch, d_conv - 1, h, p) and ``ssm`` (batch, h, p, n);

    each with an int32 ``index``: (batch,) per-slot write positions with
    ``per_slot_index`` (continuous batching), else one scalar position
    shared by every slot. All layers share one index tensor.

    Under a ``ruleset`` with a mesh, this rank's shard of those caches
    (``cache_spec``: its slots, and its kv heads, rows or SSM heads where
    they divide their axes), and each attention cache holds its k/v
    ``spec``, which the layers read (``layers._contiguous_apply``:
    the rows' split is not seen in the shapes)."""
    device = resolve_device(device)
    dtype = dtype or cfg.dtype
    sharded = ruleset is not None and ruleset.mesh is not None

    def local(kind, shape):
        if not sharded:
            return tuple(shape), None
        return sharding.local_shape(ruleset, _CACHE_DIMS[kind][:len(shape)],
                                    shape)

    def zeros(kind, shape, dt):
        return torch.zeros(local(kind, shape)[0], dtype=dt, device=device)

    index = zeros("index", (batch,), torch.int32) if per_slot_index else \
        torch.zeros((), dtype=torch.int32, device=device)
    caches = []
    for i in range(cfg.n_layers):
        if cfg.kind(i) in ("attn", "cross"):
            shape = (batch, max_len, cfg.n_kv_heads, cfg.dhead)
            c = {"k": zeros("k", shape, dtype), "v": zeros("v", shape, dtype)}
            if sharded:
                c["spec"] = local("k", shape)[1]
        else:
            c = {kind: zeros(kind, shape, dtype) for kind, shape in
                 mamba.cache_shapes(cfg.mamba_cfg(), batch).items()}
        c["index"] = index
        caches.append(c)
    return caches


def cache_lengths(caches: List[Params]) -> torch.Tensor:
    """Per-slot valid lengths, shape (batch,): the per-slot index, or a
    scalar index broadcast over the batch read off a data leaf."""
    c0 = caches[0]
    idx = c0["index"]
    if idx.dim() == 1:
        return idx
    batch = next(v for k, v in c0.items() if k != "index").shape[0]
    return idx.expand(batch).clone()


def set_cache_lengths(caches: List[Params], lengths) -> List[Params]:
    """Every layer's write position overwritten with ``lengths`` (e.g.
    after a padded bucketed prefill, whose true prompt is shorter than the
    bucket). Returns new cache dicts; the K/V and state tensors are shared."""
    idx = caches[0]["index"]
    new = torch.as_tensor(lengths, dtype=idx.dtype,
                          device=idx.device).expand(idx.shape).clone()
    return [dict(c, index=new) for c in caches]


def cache_hbm_rows(caches: List[Params]) -> int:
    """K/V rows of device memory the caches hold: ``batch * max_len`` per
    contiguous attention layer, ``n_pages * page_size`` per paged pool
    (the reservation the paged layout shrinks); Mamba state holds none."""
    total = 0
    for c in caches:
        if "kp" in c:
            total += c["kp"].shape[0] * c["kp"].shape[1]
        elif "k" in c:
            total += c["k"].shape[0] * c["k"].shape[1]
    return total


def init_paged_caches(cfg: ModelConfig, batch: int, max_len: int,
                      page_size: int, n_pages: int, device=None,
                      dtype: Optional[torch.dtype] = None) -> List[Params]:
    """Per layer: a shared K/V page pool and the slots' page table.

    * ``kp``/``vp``: (n_pages, page_size, kvh, dhead) pool in the compute
      dtype; page 0 is the null page.
    * ``pages``: (batch, max_pages) int32 page table, zero-filled, and
    * ``index``: (batch,) int32 per-slot write position — one logical
      table for every layer, so all layers share the same two tensors.
    """
    device = resolve_device(device)
    if any(k not in ("attn", "cross") for k in cfg.pattern):
        raise ValueError(f"paged K/V caches need an attention-only "
                         f"pattern, not {cfg.pattern}")
    if n_pages < 2:
        raise ValueError(f"n_pages {n_pages} < 2")
    dtype = dtype or cfg.dtype
    max_pages = -(-max_len // page_size)
    pages = torch.zeros((batch, max_pages), dtype=torch.int32, device=device)
    index = torch.zeros((batch,), dtype=torch.int32, device=device)
    shape = (n_pages, page_size, cfg.n_kv_heads, cfg.dhead)
    return [{"kp": torch.zeros(shape, dtype=dtype, device=device),
             "vp": torch.zeros(shape, dtype=dtype, device=device),
             "pages": pages, "index": index}
            for _ in range(cfg.n_layers)]
