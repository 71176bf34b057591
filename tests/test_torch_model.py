"""Model of the PyTorch port against the reference: configs, the weight
bridge, ``forward`` without a cache, and one chunked pass through paged
caches (pool contents and logits).

Weights come from the reference's ``init_params`` and cross through
numpy. Tolerance for logits and pool rows: 1e-5 absolute plus 1e-5
relative in fp32 — the two frameworks order their sums differently (XLA's
CPU dot vs torch's matmul) and RoPE's fp32 ``pow``/``sin``/``cos`` may
round differently in the last bit; logits of the smoke models are O(1).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import transformer as JT

from repro_torch import configs
from repro_torch.bridge import params_from_jax
from repro_torch.models import transformer as T

ATOL = RTOL = 1e-5
ARCHS = ["qwen3-4b", "qwen2-0.5b"]
FIELDS = ["name", "n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
          "vocab", "head_dim", "activation", "qk_norm", "qkv_bias",
          "rope_theta", "compute_dtype", "expand_kv", "attn_probs_fp32"]


@pytest.fixture(scope="module", params=ARCHS)
def bridged(request):
    arch = request.param
    jcfg = jconfigs.get_smoke(arch)
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
    cfg = configs.get_smoke(arch)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                             device="cpu")
    return jcfg, jparams, cfg, params


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("full", [True, False])
def test_configs_keep_reference_values(arch, full):
    get, jget = ((configs.get_config, jconfigs.get_config) if full
                 else (configs.get_smoke, jconfigs.get_smoke))
    cfg, jcfg = get(arch), jget(arch)
    for f in FIELDS:
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert cfg.dhead == jcfg.dhead
    # The registry leaves the knobs at the reference's defaults.
    assert cfg.attn_probs_fp32 and not cfg.expand_kv
    if full and arch == "qwen3-4b":
        assert cfg.dhead == 80          # the repo's value, not 128


def test_bridge_unstacks_layers_and_keeps_einsum_layouts(bridged):
    jcfg, jparams, cfg, params = bridged
    assert len(params["blocks"]) == cfg.n_layers
    stacked = jparams["blocks"][0]
    for i, blk in enumerate(params["blocks"]):
        for name in ("wq", "wk", "wv", "wo"):
            np.testing.assert_array_equal(
                blk["attn"][name].numpy(), np.asarray(stacked["attn"][name][i]))
    a = params["blocks"][0]["attn"]
    h, kvh, hd, d = cfg.n_heads, cfg.n_kv_heads, cfg.dhead, cfg.d_model
    assert a["wq"].shape == (d, h, hd) and a["wk"].shape == (d, kvh, hd)
    assert a["wo"].shape == (h, hd, d)


def _shapes(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_shapes(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_shapes(v, f"{prefix}/{i}"))
        return out
    return {prefix: tuple(tree.shape)}


def test_init_params_matches_bridged_structure_and_scales(bridged):
    """The port's own initialiser draws the same leaves, shapes and
    per-leaf scales (std 1/sqrt(fan_in), 1 for the embedding)."""
    jcfg, jparams, cfg, params = bridged
    gen = torch.Generator().manual_seed(1)
    mine = T.init_params(cfg, gen, device="cpu")
    assert _shapes(mine) == _shapes(params)
    ref_std = {k: float(np.asarray(v).std())
               for k, v in _flat(jax.tree.map(np.asarray, jparams)).items()}
    my_std = {k: float(v.float().std()) for k, v in _flat(mine).items()}
    for k, s in ref_std.items():
        if s > 0:
            assert abs(my_std[k] / s - 1) < 0.3, k


def _flat(p):
    """Leaf name -> all of that leaf's values (layers pooled)."""
    out = {}

    def walk(t, name):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, k)
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v, name)
        else:
            arr = t if isinstance(t, np.ndarray) else t
            out.setdefault(name, []).append(arr.reshape(-1))
    walk(p, "")
    return {k: (np.concatenate(v) if isinstance(v[0], np.ndarray)
                else torch.cat(v)) for k, v in out.items()}


def test_forward_logits_match_reference(bridged):
    jcfg, jparams, cfg, params = bridged
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, cfg.vocab, size=(2, 11)).astype(np.int32)
    want, _, _ = JT.forward(jparams, jcfg, jnp.asarray(tokens))
    got, caches = T.forward(params, cfg, torch.from_numpy(tokens))
    assert caches is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("use_flash", [False, True])
def test_chunked_paged_pass_matches_reference(bridged, use_flash):
    """Two chunks of one prompt through the paged caches (shuffled table,
    a padded final chunk) and one batched decode step: every non-null
    pool page and every logit equal the reference's paged forward. The
    port's paged attention is always its kernels' plain versions (CPU
    tensors); the reference runs either its gathered ``sdpa`` path or, with
    ``use_flash``, its Pallas kernels in interpret mode. At fp32 all three
    agree."""
    jcfg, jparams, cfg, params = bridged
    jcfg = dataclasses.replace(jcfg, use_flash=use_flash)
    batch, max_len, ps, n_pages, chunk = 2, 32, 8, 10, 8
    rng = np.random.RandomState(1)
    table = np.zeros((batch, max_len // ps), np.int32)
    table[0, :2] = [7, 3]
    table[1, :1] = [5]
    jc = JT.init_paged_caches(jcfg, batch, max_len, ps, n_pages)
    jc = [dict(c, pages=jnp.broadcast_to(jnp.asarray(table),
                                         c["pages"].shape)) for c in jc]
    tc = T.init_paged_caches(cfg, batch, max_len, ps, n_pages, device="cpu")
    tpages = torch.from_numpy(table)

    def step(jc, tokens, index, rows):
        """Forward a batch view (rows of the table) at write ``index``."""
        jview = [dict(c, pages=c["pages"][:, rows],
                      index=jnp.broadcast_to(jnp.asarray(index, jnp.int32),
                                             (c["index"].shape[0], len(rows))))
                 for c in jc]
        jl, jnew, _ = JT.forward(jparams, jcfg, jnp.asarray(tokens),
                                 caches=jview)
        jc = [dict(c, kp=n["kp"], vp=n["vp"]) for c, n in zip(jc, jnew)]
        tview = [dict(c, pages=tpages[rows].contiguous(),
                      index=torch.tensor(index, dtype=torch.int32))
                 for c in tc]
        tl, tnew = T.forward(params, cfg, torch.from_numpy(tokens),
                             caches=tview)
        assert tnew[0]["index"].tolist() == [i + tokens.shape[1]
                                             for i in index]
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   rtol=RTOL)
        return jc

    prompt = rng.randint(0, cfg.vocab, size=13).astype(np.int32)
    c0 = prompt[None, :chunk]
    c1 = np.zeros((1, chunk), np.int32)
    c1[0, :5] = prompt[chunk:]
    jc = step(jc, c0, [0], [0])
    jc = step(jc, c1, [8], [0])
    jc = step(jc, np.asarray([[prompt[-1]], [4]], np.int32), [13, 0], [0, 1])
    for layer, (j, t) in enumerate(zip(jc, tc)):
        for name in ("kp", "vp"):
            # Page 0 takes the duplicate writes of padded and idle rows;
            # their order is unspecified in both frameworks.
            np.testing.assert_allclose(t[name][1:].numpy(),
                                       np.asarray(j[name][layer][1:]),
                                       atol=ATOL, rtol=RTOL)
