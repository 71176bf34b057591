"""The model families of the PyTorch port against the reference: the
dense granite-3-8b and phi3-mini-3.8b (MHA at head_dim 96), the mixtures
of experts dbrx-132b and llama4-maverick (MoE layers alternating with
dense ones, a shared expert) and the hybrid jamba-v0.1 (Mamba and
attention at 7:1, MoE every other layer).

* configs: the reference's values, full and smoke;
* the weight bridge and cache-less smoke logits of each;
* (the engines: ``tests/test_torch_families_engine.py``);
* accounting: ``active_param_count``, ``model_flops`` and
  ``cache_hbm_rows`` equal to the reference's for every full config the
  port serves;
* the plain attention at head_dim 96 and the plain SSD scan at jamba's
  (p, n) = (64, 16) against the reference's Pallas kernels in interpret
  mode;
* a mixture of experts trains: its loss and parts equal the reference's.

Inputs and prompts are numpy arrays from seeds; the weights are the
reference's ``init_params`` carried across through numpy. The reference
runs its Pallas kernels in interpret mode (``use_flash``,
``use_ssd_kernel``), the port its kernels' plain versions (CPU tensors).
Tolerance: 1e-5 absolute plus 1e-5 relative in fp32 for logits and
attention (only the order of sums differs; smoke logits are O(1)); where
a Mamba layer's SSD scan runs at other chunk lengths on the two sides
(the port's fixed 128, masked; the reference's a divisor of the length)
it is the reference's own 2e-4 for its chunked against its sequential
scan (``tests/test_moe_mamba.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.kernels import ops as jops
from repro.kernels import ssd_scan as jssd
from repro.models import transformer as JT

from repro_torch import configs
from repro_torch.bridge import params_from_jax
from repro_torch.kernels import ops
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.train import steps

ATOL = RTOL = 1e-5
CHUNKS_DIFFER = 2e-4
FAMILIES = ["granite-3-8b", "phi3-mini-3.8b", "dbrx-132b",
            "llama4-maverick-400b-a17b", "jamba-v0.1-52b"]
FIELDS = ["name", "n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
          "vocab", "head_dim", "activation", "qk_norm", "qkv_bias",
          "rope_theta", "pattern", "moe_positions", "n_experts", "top_k",
          "n_shared_experts", "moe_impl", "moe_capacity_factor",
          "mamba_d_state", "mamba_head_dim", "mamba_expand",
          "compute_dtype"]
KERNEL_FLAGS = {"use_flash": True, "use_ssd_kernel": True}


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
    """arch -> (reference config, reference params, config, params),
    built on first use."""
    built = {}

    def get(arch):
        if arch not in built:
            jcfg = dataclasses.replace(jconfigs.get_smoke(arch),
                                       **KERNEL_FLAGS)
            cfg = configs.get_smoke(arch)
            jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
            params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                     device="cpu")
            built[arch] = (jcfg, jparams, cfg, params)
        return built[arch]

    return get


@pytest.mark.parametrize("arch", FAMILIES)
@pytest.mark.parametrize("full", [True, False])
def test_configs_keep_reference_values(arch, full):
    get, jget = ((configs.get_config, jconfigs.get_config) if full
                 else (configs.get_smoke, jconfigs.get_smoke))
    cfg, jcfg = get(arch), jget(arch)
    for f in FIELDS:
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert cfg.dhead == jcfg.dhead and cfg.periods == jcfg.periods
    assert configs.ALIASES[arch] in configs.list_archs()
    if full and arch == "phi3-mini-3.8b":
        assert cfg.dhead == 96 and cfg.n_kv_heads == cfg.n_heads
    if full and arch == "jamba-v0.1-52b":
        m = cfg.mamba_cfg()
        assert (m.head_dim, m.d_state, m.n_heads) == (64, 16, 128)


@pytest.mark.parametrize("arch", FAMILIES)
def test_bridge_carries_every_weight_and_logits_match(models, arch):
    """Every leaf of the reference's parameters lands in the port's layer
    i = position i % P, period i // P, with the shapes the port's own
    ``init_params`` draws (the router in fp32); cache-less logits match."""
    jcfg, jparams, cfg, params = models(arch)
    mine = T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    shapes = lambda p: jax.tree.map(lambda t: tuple(t.shape), p)  # noqa: E731
    assert shapes(params) == shapes(mine)
    assert T.tree_param_count(params) == JT.param_count(jcfg)
    p_len = len(cfg.pattern)
    for i, block in enumerate(params["blocks"]):
        stacked = jparams["blocks"][i % p_len]
        np.testing.assert_array_equal(
            block["ln1"]["scale"].numpy(),
            np.asarray(stacked["ln1"]["scale"][i // p_len]))
        if cfg.is_moe(i):
            assert block["moe"]["router"].dtype == torch.float32
            np.testing.assert_array_equal(
                block["moe"]["expert_down"].numpy(),
                np.asarray(stacked["moe"]["expert_down"][i // p_len]))
        else:
            assert "moe" not in block
    tokens = np.random.RandomState(3).randint(
        0, cfg.vocab, size=(2, 13)).astype(np.int32)
    want, _, _ = JT.forward(jparams, jcfg, jnp.asarray(tokens))
    got, _ = T.forward(params, cfg, torch.from_numpy(tokens))
    tol = CHUNKS_DIFFER if "mamba" in cfg.pattern else ATOL
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol,
                               rtol=tol)


SERVED = ["qwen3-4b", "qwen2-0.5b", "mamba2-370m"] + FAMILIES


@pytest.mark.parametrize("arch", SERVED)
def test_accounting_equals_the_reference(arch, monkeypatch):
    """Active parameters, MODEL_FLOPS (train, prefill, decode) and the K/V
    rows the caches hold, for every full config the port serves; the
    caches at a small batch and length (the count is per row). The
    reference's ``model_flops`` is fed its own active count, computed
    once (each call would trace the full config's ``init_params``)."""
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    active = JT.active_param_count(jcfg)
    assert T.active_param_count(cfg) == active
    assert T.param_count(cfg) == JT.param_count(jcfg)
    monkeypatch.setattr(JT, "active_param_count", lambda c: active)
    for mode, b, s, ctx in (("train", 4, 512, 0), ("prefill", 1, 2048, 0),
                            ("decode", 8, 1, 1500)):
        assert T.model_flops(cfg, b, s, mode, ctx) == \
            JT.model_flops(jcfg, b, s, mode, ctx)
    caches = T.init_caches(cfg, 2, 16, per_slot_index=True, device="cpu")
    jcaches = jax.eval_shape(lambda: JT.init_caches(jcfg, 2, 16,
                                                    per_slot_index=True))
    assert T.cache_hbm_rows(caches) == JT.cache_hbm_rows(jcaches)
    if all(k == "attn" for k in cfg.pattern):
        paged = T.init_paged_caches(cfg, 2, 16, 8, 5, device="cpu")
        jpaged = jax.eval_shape(lambda: JT.init_paged_caches(jcfg, 2, 16, 8,
                                                             5))
        assert T.cache_hbm_rows(paged) == JT.cache_hbm_rows(jpaged) == \
            cfg.n_layers * 5 * 8
    if arch == "dbrx-132b":
        assert round(T.param_count(cfg) / 1e9, 1) == 131.6


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("group", [1, 4])
def test_plain_attention_at_head_dim_96_matches_reference(group):
    """The paged decode, the paged prefill (a chunk at a later start) and
    the contiguous decode at phi3-mini's head_dim 96, groups 1 (MHA) and
    4, against the reference's Pallas kernels in interpret mode."""
    rng = np.random.RandomState(group)
    b, kvh, d, ps, max_pages, n_pages, sq = 2, 2, 96, 8, 4, 12, 8
    h = kvh * group
    kp, vp = (rng.randn(n_pages, ps, kvh, d).astype(np.float32)
              for _ in range(2))
    table = rng.permutation(np.arange(1, n_pages))[:b * max_pages].reshape(
        b, max_pages).astype(np.int32)
    lengths = np.asarray([13, 32], np.int32)
    q = rng.randn(b, h, d).astype(np.float32)
    ops.reset_launches()
    got = ops.flash_decode_paged(_t(q), _t(kp), _t(vp), _t(table),
                                 _t(lengths))
    want = jops.flash_decode_paged(*(jnp.asarray(a) for a in (
        q, kp, vp, table, lengths)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)
    starts = np.asarray([0, 19], np.int32)
    qc = rng.randn(b, sq, h, d).astype(np.float32)
    got = ops.flash_attention_paged(_t(qc), _t(kp), _t(vp), _t(table),
                                    _t(starts))
    want = jops.flash_attention_paged(*(jnp.asarray(a) for a in (
        qc, kp, vp, table, starts)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)
    k, v = (rng.randn(b, 32, kvh, d).astype(np.float32) for _ in range(2))
    got = ops.flash_decode(_t(q), _t(k), _t(v), _t(lengths))
    want = jops.flash_decode(*(jnp.asarray(a) for a in (q, k, v, lengths)),
                             block_k=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)
    assert not any(ops.LAUNCHES.values())


def test_plain_ssd_scan_at_jambas_shape_matches_reference():
    """``ops.ssd_scan`` on CPU tensors at jamba's (p, n) = (64, 16) and
    the kernel's chunk of 128 against the Pallas kernel in interpret mode:
    two chunks, 2 heads, 2 batch rows, the model's decays."""
    rng = np.random.RandomState(23)
    bt, l, h, p, n = 2, 256, 2, 64, 16
    x = rng.randn(bt, l, h, p).astype(np.float32)
    dt = np.log1p(np.exp(rng.randn(bt, l, h))).astype(np.float32)
    a = (-dt * np.linspace(1, 16, h)).astype(np.float32)
    b = (0.3 * rng.randn(bt, l, n)).astype(np.float32)
    c = (0.3 * rng.randn(bt, l, n)).astype(np.float32)
    y, state = ops.ssd_scan(*(_t(t) for t in (x, a, b, c)))
    assert state.shape == (bt, h, p, n)
    wy, ws = jssd.ssd_scan(*(jnp.asarray(t) for t in (x, a, b, c)),
                           chunk=128, interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(wy),
                               atol=CHUNKS_DIFFER, rtol=CHUNKS_DIFFER)
    np.testing.assert_allclose(state.numpy(), np.asarray(ws),
                               atol=CHUNKS_DIFFER, rtol=CHUNKS_DIFFER)


@pytest.mark.parametrize("arch", ["dbrx-132b", "llama4-maverick-400b-a17b",
                                  "jamba-v0.1-52b"])
def test_training_refuses_a_mixture_of_experts(arch):
    """A mixture of experts trains: the loss adds ``aux_weight * aux``, and
    its loss and parts equal the reference's ``loss_fn`` at rtol 1e-4
    (``tests/test_torch_train_families.py`` holds the gradients)."""
    from repro.train import steps as jsteps
    from repro_torch.data import DataConfig, SyntheticLMData

    jcfg, cfg = jconfigs.get_smoke(arch), configs.get_smoke(arch)
    jparams = jax.tree.map(np.asarray, JT.init_params(
        jax.random.PRNGKey(0), jcfg))
    tokens, labels = SyntheticLMData(DataConfig(
        vocab=cfg.vocab, seq_len=8, global_batch=2)).batch_at(0)
    jloss, jparts = jsteps.loss_fn(jparams, jcfg, {
        "tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)})
    params = params_from_jax(jparams, cfg, device="cpu",
                             dtype=torch.float32)
    batch = {"tokens": torch.from_numpy(tokens),
             "labels": torch.from_numpy(labels)}
    loss, parts = steps.loss_fn(params, cfg, batch)
    assert float(parts["aux"]) > 0
    for got, want in ((loss, jloss), (parts["nll"], jparts["nll"]),
                      (parts["aux"], jparts["aux"])):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-4)
    state, metrics = steps.make_train_step(cfg)(
        steps.TrainState(params=params, opt=adamw.adamw_init(params),
                         step=torch.zeros((), dtype=torch.int32)).tree(),
        batch)
    assert int(state["step"]) == 1
    np.testing.assert_allclose(float(metrics["loss"]), float(jloss),
                               rtol=1e-4)


@pytest.mark.parametrize("arch", ["granite-3-8b", "phi3-mini-3.8b"])
def test_dense_families_still_train(arch):
    """The dense families are plain attention stacks: the train step is
    built (``tests/test_torch_train.py`` holds the steps themselves)."""
    assert callable(steps.make_train_step(configs.get_smoke(arch)))
