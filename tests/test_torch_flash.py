"""The full-sequence attention of the PyTorch port against the reference:
the plain ``flash_attention`` and its wrapper (CPU tensors) against the
reference's Pallas kernel (interpret mode) and its oracle, the cache-less
``T.forward`` at ``use_flash`` True and False against the reference's,
and the rule that no kernel wrapper runs inside a gradient.

Tolerances: fp32 1e-5 absolute for attention outputs (the same fp32
softmax on both sides; only the order of the sums differs), 1e-4 for
logits of the smoke models (fp32; every projection, MLP and the unembed
also sum in another order in each framework, over two layers). bf16: both
sides compute the fp32 math on the same bf16 inputs and round once, so
they may differ by one bf16 step (``ref.TOLERANCE``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.kernels import ops as jops, ref as jref
from repro.models import transformer as JT

from repro_torch import configs
from repro_torch.bridge import params_from_jax
from repro_torch.kernels import ops, ref
from repro_torch.models import transformer as T
from repro_torch.serve.engine import (Request, ServeConfig, ServingEngine,
                                      greedy_generate)
from repro_torch.tree import tree_leaves, tree_map

ATOL = 1e-5
LOGIT_TOL = 1e-4

# (sq, skv): equal lengths (1, a prime, a full 64-row block plus one),
# more keys than queries (the diagonal offset), and for the non-causal
# case more queries than keys.
LENGTHS = [(1, 1), (37, 37), (65, 65), (13, 53), (1, 29)]


def _qkv(seed, b, sq, skv, h, kvh, d):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, sq, h, d).astype(np.float32),
            rng.randn(b, skv, kvh, d).astype(np.float32),
            rng.randn(b, skv, kvh, d).astype(np.float32))


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("group", [1, 2, 7])
@pytest.mark.parametrize("lengths", LENGTHS, ids=str)
def test_plain_flash_attention_matches_reference(causal, group, lengths):
    """Port plain version and wrapper (CPU) against the reference's
    oracle and its Pallas kernel in interpret mode, fp32."""
    sq, skv = lengths
    q, k, v = _qkv(sq * 100 + skv + group, 2, sq, skv, 2 * group, 2, 8)
    want_oracle = np.asarray(jref.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal))
    want_pallas = np.asarray(jops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal))
    got = ref.flash_attention(_t(q), _t(k), _t(v), causal=causal)
    via_wrapper = ops.flash_attention(_t(q), _t(k), _t(v), causal=causal)
    assert got.shape == q.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want_oracle, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), want_pallas, atol=ATOL, rtol=0)
    assert torch.equal(via_wrapper, got)


@pytest.mark.parametrize("causal", [True, False])
def test_non_causal_flash_attention_with_more_queries_than_keys(causal):
    """sq > skv is valid only without the causal mask; causal, the
    wrapper raises where the reference asserts."""
    q, k, v = _qkv(3, 1, 11, 5, 4, 2, 8)
    if causal:
        with pytest.raises(ValueError, match="sq 11 > skv 5"):
            ops.flash_attention(_t(q), _t(k), _t(v), causal=True)
        return
    want = np.asarray(jops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=False))
    got = ops.flash_attention(_t(q), _t(k), _t(v), causal=False)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_flash_attention_bf16_matches_reference(causal):
    """bf16 in, bf16 out, the fp32 math on the rounded inputs: within one
    bf16 step of the reference's bf16 oracle, and bit-equal to the port's
    own fp32 result rounded once."""
    q, k, v = _qkv(11, 2, 37, 41, 14, 2, 16)
    bf = lambda a: _t(a).to(torch.bfloat16)                  # noqa: E731
    got = ref.flash_attention(bf(q), bf(k), bf(v), causal=causal)
    assert got.dtype == torch.bfloat16
    jbf = lambda a: jnp.asarray(a, jnp.bfloat16)             # noqa: E731
    want = np.asarray(jref.flash_attention(jbf(q), jbf(k), jbf(v),
                                           causal=causal)).astype(np.float32)
    assert ref.compare(got, torch.from_numpy(want).to(torch.bfloat16))[0]
    exact = ref.flash_attention(bf(q).float(), bf(k).float(), bf(v).float(),
                                causal=causal)
    assert torch.equal(got, exact.to(torch.bfloat16))


def test_flash_wrapper_rejects_what_the_kernel_does_not_take():
    q = torch.zeros(2, 5, 4, 8)
    k = torch.zeros(2, 7, 2, 8)
    with pytest.raises(ValueError):          # head_dim mismatch
        ops.flash_attention(q, torch.zeros(2, 7, 2, 16),
                            torch.zeros(2, 7, 2, 16))
    with pytest.raises(ValueError):          # heads not a multiple of kvh
        ops.flash_attention(torch.zeros(2, 5, 3, 8), k, k)
    with pytest.raises(ValueError):          # batch mismatch
        ops.flash_attention(q, k[:1], k[:1])
    with pytest.raises(ValueError):          # k/v shapes differ
        ops.flash_attention(q, k, k[:, :6])
    with pytest.raises(ValueError):          # rank
        ops.flash_attention(q[0], k, k)
    with pytest.raises(TypeError):           # k/v dtype != q dtype
        ops.flash_attention(q, k.bfloat16(), k.bfloat16())


# ----------------------------------------------------------------------------
# The cache-less forward
# ----------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["qwen3-4b", "qwen2-0.5b"])
def bridged(request):
    jcfg = jconfigs.get_smoke(request.param)
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
    cfg = configs.get_smoke(request.param)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                             device="cpu")
    return jcfg, jparams, cfg, params


@pytest.mark.parametrize("use_flash", [True, False])
def test_cacheless_forward_matches_reference(bridged, use_flash):
    """``T.forward`` without caches, at a prime length, against the
    reference's ``forward`` with the same ``use_flash`` (its Pallas
    kernel in interpret mode, or its ``sdpa``)."""
    jcfg, jparams, cfg, params = bridged
    jcfg = dataclasses.replace(jcfg, use_flash=use_flash)
    cfg = dataclasses.replace(cfg, use_flash=use_flash)
    tokens = np.random.RandomState(1).randint(0, cfg.vocab, size=(2, 37))
    want, _, _ = JT.forward(jparams, jcfg, jnp.asarray(tokens))
    ops.reset_launches()
    got, caches = T.forward(params, cfg, torch.from_numpy(tokens))
    assert caches is None
    assert ops.LAUNCHES["flash_attention"] == 0      # CPU: the plain version
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LOGIT_TOL, rtol=LOGIT_TOL)


def test_use_flash_routes_through_the_kernel_wrapper(bridged, monkeypatch):
    """Under ``use_flash`` every layer's cache-less attention calls
    ``kernel_ops.flash_attention`` (causal), and without it none does."""
    _, _, cfg, params = bridged
    from repro_torch.models import layers

    calls = []
    real = layers.kernel_ops.flash_attention

    def spy(q, k, v, causal=True):
        calls.append(causal)
        return real(q, k, v, causal=causal)

    monkeypatch.setattr(layers.kernel_ops, "flash_attention", spy)
    tokens = torch.arange(12).reshape(2, 6) % cfg.vocab
    T.forward(params, cfg, tokens)
    assert calls == []
    T.forward(params, dataclasses.replace(cfg, use_flash=True), tokens)
    assert calls == [True] * cfg.n_layers


@pytest.mark.parametrize("use_flash", [True, False])
def test_non_causal_attention_apply_matches_reference(bridged, use_flash):
    """``AttnConfig(causal=False)`` (the reference's encoder attention)
    through ``attention_apply`` without a cache: every query sees every
    key, through the kernel or the unmasked ``sdpa``."""
    from repro.models import layers as jlayers
    from repro_torch.models import layers

    jcfg, jparams, cfg, params = bridged
    x = np.random.RandomState(2).randn(2, 13, cfg.d_model).astype(np.float32)
    jattn = jax.tree.map(lambda a: a[0], jparams["blocks"][0]["attn"])
    want, _ = jlayers.attention_apply(
        jattn, jcfg.attn_cfg(causal=False), jnp.asarray(x),
        use_flash=use_flash)
    acfg = dataclasses.replace(T.attn_cfg(cfg), causal=False)
    got, _ = layers.attention_apply(params["blocks"][0]["attn"], acfg,
                                    torch.from_numpy(x), use_flash=use_flash)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LOGIT_TOL, rtol=LOGIT_TOL)
    causal, _ = layers.attention_apply(params["blocks"][0]["attn"],
                                       T.attn_cfg(cfg), torch.from_numpy(x),
                                       use_flash=use_flash)
    assert not torch.allclose(causal, got, atol=1e-3)


# ----------------------------------------------------------------------------
# No kernel inside a gradient
# ----------------------------------------------------------------------------

def _wrapper_calls():
    """Each kernel wrapper with small valid CPU inputs; the first input
    is the one made to require grad."""
    q4, k4 = torch.randn(1, 4, 2, 8), torch.randn(1, 4, 1, 8)
    pool = torch.randn(3, 4, 1, 8)
    table = torch.tensor([[1, 2]], dtype=torch.int32)
    one = torch.tensor([4], dtype=torch.int32)
    x = torch.randn(1, 4, 2, 8)
    a = -torch.rand(1, 4, 2)
    bc = torch.randn(1, 4, 8)
    return {
        "flash_attention": (ops.flash_attention, (q4, k4, k4)),
        "flash_decode_paged": (ops.flash_decode_paged,
                               (q4[:, 0], pool, pool, table, one)),
        "flash_attention_paged": (ops.flash_attention_paged,
                                  (q4, pool, pool, table, one - 4)),
        "flash_decode": (ops.flash_decode, (q4[:, 0], k4, k4, one)),
        "ssd_scan": (ops.ssd_scan, (x, a, bc, bc)),
        "gemm": (ops.gemm, (torch.randn(5, 8), torch.randn(8, 3))),
    }


@pytest.mark.parametrize("name", sorted(_wrapper_calls()))
def test_every_wrapper_raises_inside_a_gradient(name):
    """The kernels have no backward (the reference's Pallas calls raise
    under ``jax.grad``): a wrapper given an input that requires grad
    while grad mode is on raises, on the CPU as on the card; under
    ``no_grad``, or with no input requiring grad, it runs."""
    fn, args = _wrapper_calls()[name]
    fn(*args)
    tracked = (args[0].clone().requires_grad_(),) + args[1:]
    with pytest.raises(RuntimeError, match="no backward"):
        fn(*tracked)
    with torch.no_grad():
        fn(*tracked)


@pytest.mark.parametrize("paged", [False, True])
def test_engines_serve_parameters_that_require_grad(bridged, paged):
    """Serving runs without gradients by construction: parameters that
    require grad (a model fresh from training) serve the same greedy
    streams as detached ones, through the kernel wrappers."""
    _, _, cfg, params = bridged
    tracked = tree_map(lambda t: t.clone().requires_grad_(), params)
    assert all(t.requires_grad for t in tree_leaves(tracked))
    scfg = ServeConfig(max_len=32, batch=2, paged=paged, page_size=8,
                       chunk_size=8 if paged else None)
    prompts = [np.arange(3, 3 + n, dtype=np.int32) % cfg.vocab
               for n in (5, 9, 4)]
    streams = []
    for p in (params, tracked):
        eng = ServingEngine(p, cfg, scfg, device="cpu")
        for rid, prompt in enumerate(prompts):
            eng.submit(Request(rid=rid, prompt=prompt, max_new=4))
        streams.append(eng.run_until_drained())
    assert streams[0] == streams[1]
    prompt = torch.from_numpy(np.stack(prompts[:1]).astype(np.int64))
    assert torch.equal(greedy_generate(tracked, cfg, prompt, 4),
                       greedy_generate(params, cfg, prompt, 4))
