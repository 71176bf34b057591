"""Mamba-2 (SSD, state-space duality) mixer (port of ``repro/models/mamba.py``).

As in the reference: a single B/C group shared by every head, and the
short causal conv applied to x only. ``ssd_chunked`` is the chunked SSD
algorithm of the Mamba-2 paper (arXiv:2405.21060, Listing 1) and
``ssd_reference`` the O(l) sequential recurrence, both plain fp32 PyTorch.
On the serving path a prompt (l > 1) goes through the SSD scan kernel
(``kernels.ops.ssd_scan`` at ``MambaConfig.chunk``, snapped to a chunk the
kernel instantiates; its plain version on the CPU) and one decode
step (l == 1 with a cache) through the exact recurrence. Training passes
``use_kernel=False`` (the kernel has no backward): the sequence then runs
the differentiable ``ssd_chunked`` in fp32, as the reference's default
path does (in float64 for a float64 input: ``layers.wide``).

**Over a train step's model axis** (``train.dist``) the plain path is
split by ``ssm_heads``: ``w_x``, ``w_z``, ``w_dt``, ``dt_bias``,
``A_log``, ``D`` and ``conv_w`` column-parallel over this rank's heads,
``w_ssm_out`` row-parallel and followed by a ``reduce``; ``w_B``,
``w_C`` and the input, used by every head, enter through ``copy``. The
gated RMSNorm normalises over all ``h * p`` channels: the sum of
squares is summed over the axis both ways (``TrainMesh.all_sum``) and
divided by the global width, and each rank reads its slice of the
replicated scale (taken through ``copy``). Where ``ssm_heads`` does not
divide the axis the mixer replicates and runs whole on every rank.
**Under a serving mesh** (``serve.dist.split``) the kernel path and the
cached path split the same way, with the serving collectives (``copy``
the identity, each sum one ``all_reduce``): the conv and SSM state of a
rank's cache hold its heads, as ``transformer.init_caches(...,
ruleset=)`` builds them.

Cache: ``{"conv": (b, d_conv - 1, h, p), "ssm": (b, h, p, n), "index"}``
in the cache dtype. ``mamba_apply`` returns new conv/ssm tensors (it does
not write the cache in place), cast to the cache's dtype by
``layers.cast_to`` (an int8 state saturates, as the reference's does);
it reads ``conv`` in x's dtype and ``ssm`` in fp32, as the reference.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kernel_ops
from repro_torch.models import layers
from repro_torch.serve import dist as serve_dist
from repro_torch.train import dist as train_dist

Params = Dict[str, object]
# The reference's name for the decode cache, the module note's {"conv",
# "ssm", "index"}.
MambaCache = Dict[str, object]


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_model: int
    d_state: int = 128          # N
    head_dim: int = 64          # P
    expand: int = 2
    d_conv: int = 4
    chunk: int = 128

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim


def mamba_init(generator: torch.Generator, cfg: MambaConfig, device,
               dtype: torch.dtype) -> Params:
    """The reference's distributions (``mamba.mamba_init``): normal times
    1/sqrt(fan_in) for the projections, 0.5 for the conv, 1/sqrt(h p) for
    the output projection; ``dt_bias`` zeros, ``A_log`` log(linspace(1,
    16, h)), ``D`` and the norm scale ones. Projections and the conv are
    stored in ``dtype``; ``dt_bias``, ``A_log``, ``D`` and the norm scale
    in fp32 (the reference casts them at use)."""
    d, h, p, n = cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_state

    def normal(shape, scale=None):
        scale = scale if scale is not None else 1.0 / math.sqrt(shape[0])
        w = torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32)
        return (w * scale).to(dtype)

    f32 = dict(device=device, dtype=torch.float32)
    return {
        "w_x": normal((d, h, p)),
        "w_z": normal((d, h, p)),
        "w_B": normal((d, n)),
        "w_C": normal((d, n)),
        "w_dt": normal((d, h)),
        "dt_bias": torch.zeros(h, **f32),
        "A_log": torch.log(torch.linspace(1.0, 16.0, h, **f32)),
        "D": torch.ones(h, **f32),
        "conv_w": normal((cfg.d_conv, h, p), scale=0.5),
        "norm": {"scale": torch.ones(h * p, **f32)},
        "w_ssm_out": normal((h, p, d), scale=1.0 / math.sqrt(h * p)),
    }


def _segsum(a):
    """(..., l) -> (..., l, l): S[i, j] = sum_{j < m <= i} a[m], -inf above
    the diagonal."""
    l = a.shape[-1]
    cum = torch.cumsum(a, dim=-1)
    s = cum[..., :, None] - cum[..., None, :]
    mask = torch.tril(torch.ones((l, l), dtype=torch.bool, device=a.device))
    return s.masked_fill(~mask, -math.inf)


def ssd_chunked(x, a_log, b, c, chunk: int,
                h0: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD, in x's dtype (fp32 on every caller).

    x: (bt, l, h, p) inputs (already dt-scaled); a_log: (bt, l, h) per-step
    log decay (dt * A, negative); b, c: (bt, l, n) (single group); l a
    multiple of ``chunk``. Returns (y (bt, l, h, p), final state
    (bt, h, p, n))."""
    bt, l, h, p = x.shape
    n = b.shape[-1]
    if l % chunk:
        raise ValueError(f"length {l} is not a multiple of chunk {chunk}")
    nc = l // chunk
    xc = x.reshape(bt, nc, chunk, h, p)
    ac = a_log.reshape(bt, nc, chunk, h).permute(0, 3, 1, 2)  # (bt,h,nc,q)
    bc = b.reshape(bt, nc, chunk, n)
    cc = c.reshape(bt, nc, chunk, n)
    a_cum = torch.cumsum(ac, dim=-1)                           # (bt,h,nc,q)

    # 1. Intra-chunk (diagonal blocks): attention-like with a decay mask.
    decay = torch.exp(_segsum(ac))                             # (bt,h,nc,q,q)
    scores = torch.einsum("bcln,bcsn->bcls", cc, bc)
    y_diag = torch.einsum("bcls,bhcls,bcshp->bclhp", scores, decay, xc)

    # 2. Per-chunk final states.
    decay_states = torch.exp(a_cum[..., -1:] - a_cum)          # (bt,h,nc,q)
    states = torch.einsum("bcln,bhcl,bclhp->bchpn", bc, decay_states, xc)

    # 3. Inter-chunk recurrence over the chunk states.
    chunk_decay = torch.exp(a_cum[..., -1])                    # (bt,h,nc)
    carry = (torch.zeros((bt, h, p, n), dtype=x.dtype, device=x.device)
             if h0 is None else h0.to(x.dtype))
    prev = []
    for i in range(nc):
        prev.append(carry)                                     # emit previous
        carry = carry * chunk_decay[:, :, i, None, None] + states[:, i]
    prev_states = torch.stack(prev, dim=1)                     # (bt,nc,h,p,n)

    # 4. State -> output within each chunk.
    state_decay = torch.exp(a_cum)                             # (bt,h,nc,q)
    y_off = torch.einsum("bcln,bchpn,bhcl->bclhp", cc, prev_states,
                         state_decay)
    return (y_diag + y_off).reshape(bt, l, h, p), carry


def ssd_reference(x, a_log, b, c, h0=None):
    """The O(l) sequential recurrence in fp32 (the decode step's path)."""
    bt, l, h, p = x.shape
    n = b.shape[-1]
    state = (torch.zeros((bt, h, p, n), dtype=torch.float32, device=x.device)
             if h0 is None else h0.float())
    ys = []
    for t in range(l):
        state = (state * torch.exp(a_log[:, t])[..., None, None]
                 + torch.einsum("bhp,bn->bhpn", x[:, t], b[:, t]))
        ys.append(torch.einsum("bhpn,bn->bhp", state, c[:, t]))
    return torch.stack(ys, dim=1), state


def _causal_conv(x, w, cache_conv=None):
    """Depthwise causal conv along seq, then SiLU. x: (b, l, h, p),
    w: (k, h, p); ``cache_conv`` holds the k - 1 rows before x. Returns
    (out, the last k - 1 rows of the padded input)."""
    k = w.shape[0]
    if cache_conv is None:
        pad = x.new_zeros((x.shape[0], k - 1) + tuple(x.shape[2:]))
    else:
        pad = cache_conv.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    out = sum(xp[:, i:i + x.shape[1]] * w[i].to(x.dtype) for i in range(k))
    new_cache = xp[:, -(k - 1):] if k > 1 else None
    return F.silu(out), new_cache


def mamba_apply(params: Params, cfg: MambaConfig, x,
                cache: Optional[MambaCache] = None, use_kernel: bool = True
                ) -> Tuple[torch.Tensor, Optional[MambaCache]]:
    """Mamba-2 mixer. x: (b, l, d_model) -> (b, l, d_model).

    With a cache, l == 1 runs the exact one-step recurrence from the
    cached state; l > 1 runs the SSD scan kernel at ``cfg.chunk`` from the
    cached state (the reference's kernel branch starts from zeros
    instead: a fault recorded in ROADMAP Queue 3, not copied).
    ``use_kernel=False`` runs the sequence through ``ssd_chunked`` in
    fp32 instead, its chunk halved from ``cfg.chunk`` until it divides l
    (the reference's ``use_kernel=False`` branch): the path a gradient
    can pass."""
    split = None if use_kernel or cache is not None else \
        train_dist.sharded("ssm_heads", cfg.n_heads)
    if split is None:
        split = serve_dist.split("ssm_heads", cfg.n_heads)
    w_b, w_c = params["w_B"], params["w_C"]
    if split is not None:
        tm, axis = split
        x = tm.copy(x, axis)
        w_b, w_c = tm.copy(w_b, axis), tm.copy(w_c, axis)
    b_, l, _ = x.shape
    h, p = params["w_x"].shape[1], cfg.head_dim       # this rank's heads
    dtype = x.dtype
    xin = layers._matmul_heads(x, params["w_x"])                # (b,l,h,p)
    z = layers._matmul_heads(x, params["w_z"])
    bmat = x @ w_b.to(dtype)                                     # (b,l,n)
    cmat = x @ w_c.to(dtype)
    dt = F.softplus(x @ params["w_dt"].to(dtype)
                    + params["dt_bias"].to(dtype))               # (b,l,h)
    wide = layers.wide(dtype)              # fp32, or float64 for float64
    a = -torch.exp(params["A_log"].to(wide))                     # (h,)

    xin, new_conv = _causal_conv(xin, params["conv_w"],
                                 None if cache is None else cache["conv"])
    a_log = dt.to(wide) * a                                      # (b,l,h)
    x_scaled = xin * dt[..., None].to(dtype)
    h0 = None if cache is None else cache["ssm"].float()
    if cache is not None and l == 1:
        y, hn = ssd_reference(x_scaled.float(), a_log, bmat.float(),
                              cmat.float(), h0=h0)
        y = y.to(dtype)
    elif use_kernel:
        y, hn = kernel_ops.ssd_scan(x_scaled, a_log, bmat, cmat, h0=h0,
                                    chunk=cfg.chunk)
    else:
        chunk = min(cfg.chunk, l)
        while l % chunk:
            chunk //= 2
        y, hn = ssd_chunked(x_scaled.to(wide), a_log, bmat.to(wide),
                            cmat.to(wide), chunk, h0=h0)
        y = y.to(dtype)

    y = y + xin * params["D"].to(dtype)[None, None, :, None]
    y = y * F.silu(z)
    if split is None:
        y = layers.rmsnorm(params["norm"], y.reshape(b_, l, h * p))
    else:
        y = _split_rmsnorm(params["norm"], y.reshape(b_, l, h * p),
                           cfg.n_heads * p, *split)
    out = layers._matmul_out(y.reshape(b_, l, h, p), params["w_ssm_out"])
    if split is not None:
        out = split[0].reduce(out, split[1])          # w_ssm_out's rows
    new_cache = None
    if cache is not None:
        new_cache = {"conv": layers.cast_to(new_conv, cache["conv"].dtype),
                     "ssm": layers.cast_to(hn, cache["ssm"].dtype),
                     "index": cache["index"] + l}
    return out, new_cache


def _split_rmsnorm(params: Params, y, width: int, tm, axis: str,
                   eps: float = 1e-6):
    """``layers.rmsnorm`` over ``width`` channels of which this rank holds
    ``y``'s last dim (a block in rank order): the sum of squares summed
    over the axis both ways, divided by the global ``width``; this rank's
    slice of the replicated scale, whose gradient is partial here."""
    dtype = y.dtype
    yf = y.to(layers.wide(dtype))
    var = tm.all_sum(yf.square().sum(dim=-1, keepdim=True), axis) / width
    n = y.shape[-1]
    scale = tm.copy(params["scale"], axis).narrow(
        0, tm.mesh.index(axis) * n, n)
    return (yf * torch.rsqrt(var + eps) * scale).to(dtype)


def cache_shapes(cfg: MambaConfig, batch: int) -> Dict[str, tuple]:
    """The conv and SSM state's shapes for ``batch`` slots."""
    h, p, n = cfg.n_heads, cfg.head_dim, cfg.d_state
    return {"conv": (batch, cfg.d_conv - 1, h, p), "ssm": (batch, h, p, n)}


def init_cache(cfg: MambaConfig, batch: int, device,
               dtype: torch.dtype) -> Params:
    """Zero conv and SSM state for ``batch`` slots (no ``index``: the
    caller adds the one it needs)."""
    return {k: torch.zeros(shape, dtype=dtype, device=device)
            for k, shape in cache_shapes(cfg, batch).items()}
