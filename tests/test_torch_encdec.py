"""The encoder-decoder and cross-attention families of the PyTorch port
against the reference: whisper-medium (LayerNorm, GELU with biases, qkv
biases, no RoPE: sinusoidal positions, a 24-layer encoder over 1500
stubbed audio frames) and llama-3.2-vision-90b (a tanh-gated
cross-attention layer every fifth layer, over 1601 stubbed patch
embeddings).

* configs: the reference's values, full and smoke;
* LayerNorm, both sinusoid recipes, the cross-attention, the encoder;
* cache-less logits, a cached decode step with a frontend and
  ``greedy_generate`` with a frontend, of both smokes;
* whisper's logits do not depend on its frontend (its pattern has no
  cross layer), in both packages; vision's do;
* accounting of both full configs equal to the reference's;
* the serving engine and the serve launcher refuse both;
* decoder positions under per-slot caches: the reference starts every
  slot at slot 0's position, the port at each slot's own.

Random init hides what these layers add: the cross-attention's gate, the
qkv biases, the MLP's ``b_up`` and LayerNorm's bias all start at zero.
Every test sets them to seeded non-zero values (the gate near 0.5) in the
reference's numpy tree before either package sees it.

Inputs and prompts are numpy arrays from seeds. The reference runs its
Pallas kernels in interpret mode (``use_flash``), the port its kernels'
plain versions (CPU tensors). Tolerance: 1e-5 absolute plus 1e-5
relative in fp32 (only the order of sums differs; smoke logits are O(1)).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.serve import engine as jengine

from repro_torch import configs
from repro_torch.bridge import params_from_jax
from repro_torch.launch import serve as serve_launch
from repro_torch.models import layers
from repro_torch.models import transformer as T
from repro_torch.serve import engine
from repro_torch.serve.engine import ServeConfig, ServingEngine

ATOL = RTOL = 1e-5
ARCHS = ["whisper-medium", "llama-3.2-vision-90b"]
FIELDS = ["name", "n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
          "vocab", "head_dim", "norm", "activation", "qk_norm", "qkv_bias",
          "rope_theta", "pattern", "moe_positions", "n_experts", "top_k",
          "n_frontend_tokens", "compute_dtype"]
ZERO_AT_INIT = ("bias", "b_q", "b_k", "b_v", "b_up")


def nonzero_init(tree, seed=1):
    """The reference's parameters as numpy, with every leaf that starts
    at zero set to seeded values: the gate to 0.5 plus noise, biases to
    0.1 times a standard normal."""
    rng = np.random.RandomState(seed)

    def leaf(path, a):
        name, a = getattr(path[-1], "key", None), np.array(a)
        if name == "gate":
            return np.asarray(0.5 + 0.1 * rng.randn(*a.shape), np.float32)
        if name in ZERO_AT_INIT:
            return np.asarray(0.1 * rng.randn(*a.shape), np.float32)
        return a

    return jax.tree_util.tree_map_with_path(leaf, tree)


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread for these smoke-size tensors: the suite's
    parallel workers would otherwise oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """arch -> (reference config, reference params, config, params)."""
    built = {}

    def get(arch):
        if arch not in built:
            jcfg = dataclasses.replace(jconfigs.get_smoke(arch),
                                       use_flash=True)
            cfg = configs.get_smoke(arch)
            np_params = nonzero_init(JT.init_params(jax.random.PRNGKey(0),
                                                    jcfg))
            jparams = jax.tree.map(jnp.asarray, np_params)
            params = params_from_jax(np_params, cfg, device="cpu")
            built[arch] = (jcfg, jparams, cfg, params)
        return built[arch]

    return get


def _inputs(cfg, b=2, s=13, seed=3):
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, cfg.vocab, size=(b, s)).astype(np.int32)
    frontend = rng.randn(b, cfg.n_frontend_tokens,
                         cfg.d_model).astype(np.float32)
    return tokens, frontend


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("full", [True, False])
def test_configs_keep_reference_values(arch, full):
    get, jget = ((configs.get_config, jconfigs.get_config) if full
                 else (configs.get_smoke, jconfigs.get_smoke))
    cfg, jcfg = get(arch), jget(arch)
    for f in FIELDS:
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert (cfg.encoder is None) == (jcfg.encoder is None)
    if cfg.encoder is not None:
        assert (cfg.encoder.n_layers, cfg.encoder.n_ctx) == \
            (jcfg.encoder.n_layers, jcfg.encoder.n_ctx)
    assert cfg.dhead == jcfg.dhead and cfg.periods == jcfg.periods
    assert configs.ALIASES[arch] in configs.list_archs()


@pytest.mark.parametrize("kind", ["layer", "rms"])
def test_norms_match_reference(kind):
    rng = np.random.RandomState(0)
    x = (3.0 + 2.0 * rng.randn(2, 5, 48)).astype(np.float32)
    p = {"scale": (1 + 0.1 * rng.randn(48)).astype(np.float32)}
    if kind == "layer":
        p["bias"] = (0.1 * rng.randn(48)).astype(np.float32)
    want = JL.norm(kind, jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    got = layers.norm(kind, {k: torch.from_numpy(v) for k, v in p.items()},
                      torch.from_numpy(x))
    _close(got, want)
    if kind == "layer":
        _close(layers.layernorm({k: torch.from_numpy(v) for k, v in
                                 p.items()}, torch.from_numpy(x)),
               JL.layernorm(jax.tree.map(jnp.asarray, p), jnp.asarray(x)))


def _reference_decoder_sinusoid(idx, d):
    """The reference's decoder positions, ``transformer.forward``'s
    fp32 recipe (``repro/models/transformer.py:314-322``) as it is."""
    dim = jnp.arange(d // 2, dtype=jnp.float32)
    angle = idx[:, None].astype(jnp.float32) / jnp.power(
        10000.0, 2 * dim / d)[None, :]
    return jnp.concatenate([jnp.sin(angle), jnp.cos(angle)], axis=-1)


def test_both_sinusoid_recipes_match_reference():
    """The encoder's table (float64 then fp32) is the reference's bit for
    bit; the decoder's fp32 recipe matches the reference's within the
    tolerance. At whisper's 1500 x 1024 the two recipes differ by more
    than the tolerance, which is why each is kept as it is."""
    n, d = 1500, 1024
    table = layers.sinusoidal_positions(n, d)
    np.testing.assert_array_equal(table.numpy(),
                                  np.asarray(JL.sinusoidal_positions(n, d)))
    assert table.dtype == torch.float32
    dec = T.sinusoid_at(torch.arange(n), d)
    _close(dec, _reference_decoder_sinusoid(jnp.arange(n), d))
    assert float((dec - table).abs().max()) > ATOL
    # Per-slot starts: a (b, s) grid of positions.
    pos = torch.tensor([[3, 4], [7, 8]])
    assert torch.equal(T.sinusoid_at(pos, d)[1, 0], dec[7])


@pytest.mark.parametrize("qk_norm", [False, True])
def test_cross_attention_matches_reference(qk_norm):
    """Queries from x, keys and values from the frontend's tokens (GQA 4
    over 2), the gate at a seeded non-zero value."""
    rng = np.random.RandomState(5)
    acfg = dict(d_model=32, n_heads=4, n_kv_heads=2, head_dim=8,
                qk_norm=qk_norm, causal=False)
    jp = JL.cross_attention_init(jax.random.PRNGKey(1),
                                 JL.AttnConfig(**acfg))
    np_p = nonzero_init(jp)
    if qk_norm:
        for k in ("q_norm", "k_norm"):
            np_p[k]["scale"] = (1 + 0.1 * rng.randn(8)).astype(np.float32)
    x = rng.randn(2, 7, 32).astype(np.float32)
    src = rng.randn(2, 9, 32).astype(np.float32)
    want = JL.cross_attention_apply(jax.tree.map(jnp.asarray, np_p),
                                    JL.AttnConfig(**acfg), jnp.asarray(x),
                                    jnp.asarray(src))
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), np_p)
    got = layers.cross_attention_apply(tp, layers.AttnConfig(**acfg),
                                       torch.from_numpy(x),
                                       torch.from_numpy(src))
    assert abs(float(np_p["gate"])) > 0.2
    _close(got, want)


def test_encode_matches_reference(models):
    jcfg, jparams, cfg, params = models("whisper-medium")
    _, frontend = _inputs(cfg)
    want = JT.encode(jparams, jcfg, jnp.asarray(frontend))
    got = T.encode(params, cfg, torch.from_numpy(frontend))
    assert got.shape == (2, cfg.encoder.n_ctx, cfg.d_model)
    _close(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_and_cacheless_logits_match_reference(models, arch):
    """Every leaf lands in the port's layout with the shapes its own
    ``init_params`` draws (norm biases and the gate fp32); cache-less
    logits with a frontend match."""
    jcfg, jparams, cfg, params = models(arch)
    mine = T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    shapes = lambda p: jax.tree.map(lambda t: tuple(t.shape), p)  # noqa: E731
    assert shapes(params) == shapes(mine)
    assert T.tree_param_count(params) == JT.param_count(jcfg) == \
        T.param_count(cfg)
    if cfg.encoder is not None:
        assert len(params["encoder"]["blocks"]) == cfg.encoder.n_layers
        assert params["encoder"]["ln_f"]["bias"].dtype == torch.float32
    for i, block in enumerate(params["blocks"]):
        assert ("xattn" in block) == (cfg.kind(i) == "cross")
        if "xattn" in block:
            assert block["xattn"]["gate"].dtype == torch.float32
            assert block["xattn"]["gate"].shape == ()
    tokens, frontend = _inputs(cfg)
    want, _, _ = JT.forward(jparams, jcfg, jnp.asarray(tokens),
                            frontend_embeds=jnp.asarray(frontend))
    got, _ = T.forward(params, cfg, torch.from_numpy(tokens),
                       frontend_embeds=torch.from_numpy(frontend))
    _close(got, want)
    got_flash, _ = T.forward(params, dataclasses.replace(cfg, use_flash=True),
                             torch.from_numpy(tokens),
                             frontend_embeds=torch.from_numpy(frontend))
    _close(got_flash, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_cached_decode_step_with_frontend_matches_reference(models, arch):
    """The counterpart of ``test_arch_smoke.py::test_smoke_decode_step``
    with numbers: a 5-token prefill and a decode step through contiguous
    caches, each with the frontend, against the reference's."""
    jcfg, jparams, cfg, params = models(arch)
    tokens, frontend = _inputs(cfg, s=6)
    jfe, fe = jnp.asarray(frontend), torch.from_numpy(frontend)
    jc = JT.init_caches(jcfg, 2, 8)
    tc = T.init_caches(cfg, 2, 8, device="cpu")
    want_pre, jc, _ = JT.forward(jparams, jcfg, jnp.asarray(tokens[:, :5]),
                                 frontend_embeds=jfe, caches=jc)
    got_pre, tc = T.forward(params, cfg, torch.from_numpy(tokens[:, :5]),
                            caches=tc, frontend_embeds=fe)
    _close(got_pre, want_pre)
    want, _, _ = JT.forward(jparams, jcfg, jnp.asarray(tokens[:, 5:]),
                            frontend_embeds=jfe, caches=jc)
    got, _ = T.forward(params, cfg, torch.from_numpy(tokens[:, 5:]),
                       caches=tc, frontend_embeds=fe)
    assert got.shape == (2, 1, cfg.vocab)
    _close(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_generate_with_frontend_matches_reference(models, arch):
    jcfg, jparams, cfg, params = models(arch)
    tokens, frontend = _inputs(cfg, s=7, seed=8)
    want = jengine.greedy_generate(jparams, jcfg, jnp.asarray(tokens), 6,
                                   frontend_embeds=jnp.asarray(frontend))
    got = engine.greedy_generate(params, cfg, torch.from_numpy(tokens), 6,
                                 frontend_embeds=torch.from_numpy(frontend))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_whisper_logits_ignore_the_frontend(models):
    """whisper-medium's pattern has no cross layer: the encoder's output
    reaches no logit, in either package, and the port does not run the
    encoder at all (the reference runs it and drops the output)."""
    jcfg, jparams, cfg, params = models("whisper-medium")
    tokens, fe1 = _inputs(cfg, seed=3)
    fe2 = 10 * _inputs(cfg, seed=4)[1]
    j1, j2 = (np.asarray(JT.forward(jparams, jcfg, jnp.asarray(tokens),
                                    frontend_embeds=jnp.asarray(fe))[0])
              for fe in (fe1, fe2))
    np.testing.assert_array_equal(j1, j2)
    t1, t2 = (T.forward(params, cfg, torch.from_numpy(tokens),
                        frontend_embeds=torch.from_numpy(fe))[0]
              for fe in (fe1, fe2))
    assert torch.equal(t1, t2)
    assert torch.equal(t1, T.forward(params, cfg,
                                     torch.from_numpy(tokens))[0])
    assert T.cross_source(params, cfg, torch.from_numpy(fe1)) is None


def test_vision_logits_follow_the_frontend_through_the_gate(models):
    """The cross-attention reaches vision's logits through its non-zero
    gate, and only through it: at gate 0 the frontend changes nothing.
    Without a frontend the cross layer raises."""
    jcfg, jparams, cfg, params = models("llama-3.2-vision-90b")
    tokens, fe1 = _inputs(cfg, seed=3)
    fe2 = _inputs(cfg, seed=4)[1]
    run = lambda p, fe: T.forward(  # noqa: E731
        p, cfg, torch.from_numpy(tokens), frontend_embeds=torch.from_numpy(
            fe))[0]
    assert float((run(params, fe1) - run(params, fe2)).abs().max()) > 1e-2
    shut = dict(params, blocks=[
        dict(b, xattn=dict(b["xattn"], gate=torch.zeros(())))
        if "xattn" in b else b for b in params["blocks"]])
    assert torch.equal(run(shut, fe1), run(shut, fe2))
    with pytest.raises(ValueError, match="frontend_embeds"):
        T.forward(params, cfg, torch.from_numpy(tokens))


@pytest.mark.parametrize("arch", ARCHS)
def test_accounting_equals_the_reference(arch, monkeypatch):
    """Parameters (the encoder and the cross layers counted), active
    parameters, MODEL_FLOPS (train, prefill, decode) and the K/V rows
    the caches hold, contiguous and paged, for the full configs. The
    reference's ``model_flops`` is fed its own active count, computed
    once."""
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    total = JT.param_count(jcfg)
    assert T.param_count(cfg) == total
    assert T.active_param_count(cfg) == JT.active_param_count(jcfg) == total
    assert T.n_attention_layers(cfg) == cfg.n_layers
    monkeypatch.setattr(JT, "active_param_count", lambda c: total)
    for mode, b, s, ctx in (("train", 4, 448, 0), ("prefill", 1, 2048, 0),
                            ("decode", 8, 1, 1500)):
        assert T.model_flops(cfg, b, s, mode, ctx) == \
            JT.model_flops(jcfg, b, s, mode, ctx)
    small = dataclasses.replace(cfg, n_layers=len(cfg.pattern))
    jsmall = dataclasses.replace(jcfg, n_layers=len(jcfg.pattern))
    caches = T.init_caches(small, 2, 16, per_slot_index=True, device="cpu")
    jcaches = jax.eval_shape(lambda: JT.init_caches(jsmall, 2, 16,
                                                    per_slot_index=True))
    assert T.cache_hbm_rows(caches) == JT.cache_hbm_rows(jcaches) == \
        small.n_layers * 2 * 16
    paged = T.init_paged_caches(small, 2, 16, 8, 5, device="cpu")
    jpaged = jax.eval_shape(lambda: JT.init_paged_caches(jsmall, 2, 16, 8, 5))
    assert T.cache_hbm_rows(paged) == JT.cache_hbm_rows(jpaged)
    billions = {"whisper-medium": 0.7, "llama-3.2-vision-90b": 90.7}[arch]
    assert round(total / 1e9, 1) == billions


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_and_launcher_refuse_encoder_and_frontend_configs(arch):
    """As the reference's: the serving engine's requests carry no
    frontend, so it refuses these configs at construction, and the serve
    launcher exits with the reference's message."""
    cfg = configs.get_smoke(arch)
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    for paged in (False, True):
        with pytest.raises(ValueError, match="decoder-only"):
            ServingEngine(params, cfg, ServeConfig(
                max_len=32, batch=2, paged=paged, page_size=8, chunk_size=8),
                device="cpu")
    with pytest.raises(SystemExit, match="decoder-only archs"):
        serve_launch.main(["--arch", arch, "--smoke", "--device", "cpu",
                           "--max-len", "32", "--max-new", "2"])


def _slot_caches(jcfg, cfg, index):
    """Per-slot caches at write positions ``index`` (zero K/V rows)."""
    jc = JT.init_caches(jcfg, len(index), 16, per_slot_index=True)
    jc = JT.set_cache_lengths(jc, jnp.asarray(index, jnp.int32))
    tc = T.init_caches(cfg, len(index), 16, per_slot_index=True,
                       device="cpu")
    return jc, T.set_cache_lengths(tc, index)


def test_per_slot_positions_start_at_each_slots_own_index(models):
    """The reference's ``caches_index`` reads ``index.reshape(-1)[0]``, so
    under per-slot caches every slot of whisper's decoder gets slot 0's
    position; the port gives each slot its own. Slot 0 agrees, slot 1
    (index 7, not 3) does not, and the port's slot 1 is what a lone slot
    at position 7 gives."""
    jcfg, jparams, cfg, params = models("whisper-medium")
    tok, fe = _inputs(cfg, s=1)
    jc, tc = _slot_caches(jcfg, cfg, [3, 7])
    want, _, _ = JT.forward(jparams, jcfg, jnp.asarray(tok),
                            frontend_embeds=jnp.asarray(fe), caches=jc)
    got, _ = T.forward(params, cfg, torch.from_numpy(tok), caches=tc)
    want = np.asarray(want)
    np.testing.assert_allclose(got[0].numpy(), want[0], atol=ATOL, rtol=RTOL)
    assert float(np.abs(got[1].numpy() - want[1]).max()) > 1e-3
    _, lone = _slot_caches(jcfg, cfg, [7])
    alone, _ = T.forward(params, cfg, torch.from_numpy(tok[1:]), caches=lone)
    _close(got[1], alone[0])


@pytest.mark.parametrize("index", [[5, 5], [0, 0]])
def test_per_slot_positions_agree_under_a_shared_index(models, index):
    """Where every slot shares one position (``greedy_generate``'s case)
    the two packages agree, per-slot caches or not."""
    jcfg, jparams, cfg, params = models("whisper-medium")
    tok, fe = _inputs(cfg, s=1, seed=6)
    jc, tc = _slot_caches(jcfg, cfg, index)
    want, _, _ = JT.forward(jparams, jcfg, jnp.asarray(tok),
                            frontend_embeds=jnp.asarray(fe), caches=jc)
    got, _ = T.forward(params, cfg, torch.from_numpy(tok), caches=tc)
    _close(got, want)
