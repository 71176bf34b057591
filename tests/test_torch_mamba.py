"""Mamba-2 mixer of the PyTorch port against the reference: configs, the
plain SSD algorithms, ``mamba_apply`` over a full sequence and step by
step with a cache, the weight bridge, and ``mamba2-370m`` smoke logits.

Inputs come from numpy seeds and cross to both frameworks as arrays. The
reference runs its SSD scan as the Pallas kernel in interpret mode
(``use_kernel`` / ``use_ssd_kernel``), the port its kernel wrapper's plain
version (CPU tensors). Tolerance: 1e-5 absolute plus 1e-5 relative in fp32
where both sides run the same algorithm at the same chunk (only the order
of sums differs; the smoke activations are O(1)). Where the chunk lengths
differ (the port scans in fixed chunks of 128 with the last one masked,
the reference's wrapper at a divisor of the length) it is the reference's
own tolerance for its chunked against its sequential scan, 2e-4 absolute
plus 2e-4 relative (``tests/test_moe_mamba.py``): a decay
exp(a_cum[i] - a_cum[j]) is a difference of cumulative sums that grow over
a chunk, so a longer chunk rounds it more coarsely.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import mamba as jmamba
from repro.models import transformer as JT

from repro_torch import configs
from repro_torch.bridge import params_from_jax
from repro_torch.kernels import ops
from repro_torch.models import mamba
from repro_torch.models import transformer as T

ATOL = RTOL = 1e-5
CHUNKS_DIFFER = 2e-4
FIELDS = ["name", "n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
          "vocab", "pattern", "mamba_d_state", "mamba_head_dim",
          "mamba_expand", "compute_dtype", "periods"]


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("full", [True, False])
def test_mamba2_config_keeps_reference_values(full):
    get, jget = ((configs.get_config, jconfigs.get_config) if full
                 else (configs.get_smoke, jconfigs.get_smoke))
    cfg, jcfg = get("mamba2-370m"), jget("mamba2-370m")
    for f in FIELDS:
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert dataclasses.asdict(cfg.mamba_cfg()) == \
        dataclasses.asdict(jcfg.mamba_cfg())
    if full:
        m = cfg.mamba_cfg()
        assert (cfg.n_layers, m.n_heads, m.head_dim, m.d_state, m.chunk) == \
            (48, 32, 64, 128, 128)


def _ssd_inputs(rng, bt, l, h, p, n):
    x = rng.randn(bt, l, h, p).astype(np.float32)
    a = -np.abs(rng.randn(bt, l, h)).astype(np.float32) * 0.5
    b = rng.randn(bt, l, n).astype(np.float32) * 0.5
    c = rng.randn(bt, l, n).astype(np.float32) * 0.5
    h0 = rng.randn(bt, h, p, n).astype(np.float32) * 0.5
    return x, a, b, c, h0


@pytest.mark.parametrize("with_h0", [False, True])
def test_plain_ssd_algorithms_match_reference(with_h0):
    rng = np.random.RandomState(4)
    x, a, b, c, h0 = _ssd_inputs(rng, 2, 24, 3, 4, 5)
    h0 = h0 if with_h0 else None
    wy, ws = jmamba.ssd_chunked(jnp.asarray(x), jnp.asarray(a),
                                jnp.asarray(b), jnp.asarray(c), 8,
                                h0=None if h0 is None else jnp.asarray(h0))
    gy, gs = mamba.ssd_chunked(_t(x), _t(a), _t(b), _t(c), 8,
                               h0=None if h0 is None else _t(h0))
    _close(gy, wy)
    _close(gs, ws)
    ry, rs = jmamba.ssd_reference(jnp.asarray(x), jnp.asarray(a),
                                  jnp.asarray(b), jnp.asarray(c),
                                  h0=None if h0 is None else jnp.asarray(h0))
    py, ps = mamba.ssd_reference(_t(x), _t(a), _t(b), _t(c),
                                 h0=None if h0 is None else _t(h0))
    _close(py, ry)
    _close(ps, rs)
    a3 = rng.randn(2, 3, 6).astype(np.float32)
    seg = mamba._segsum(_t(a3)).numpy()
    want = np.asarray(jmamba._segsum(jnp.asarray(a3)))
    finite = np.isfinite(want)
    assert (np.isfinite(seg) == finite).all()
    _close(seg[finite], want[finite])


@pytest.fixture(scope="module")
def mixer():
    jcfg = jconfigs.get_smoke("mamba2-370m").mamba_cfg()
    jp = jmamba.mamba_init(jax.random.PRNGKey(3), jcfg)
    cfg = configs.get_smoke("mamba2-370m")
    tp = {k: (_t(v) if not isinstance(v, dict)
              else {kk: _t(vv) for kk, vv in v.items()})
          for k, v in jax.tree.map(np.asarray, jp).items()}
    return jcfg, jp, cfg.mamba_cfg(), tp


@pytest.mark.parametrize("length", [1, 9, 130])
def test_mamba_apply_full_sequence_matches_reference(mixer, length):
    """No cache: the port's SSD scan (plain version, fixed chunk with the
    last chunk masked) against the reference's Pallas kernel at its own
    chunk (a divisor of the length)."""
    jcfg, jp, cfg, tp = mixer
    x = np.random.RandomState(length).randn(2, length, cfg.d_model) \
        .astype(np.float32)
    want, _ = jmamba.mamba_apply(jp, jcfg, jnp.asarray(x), use_kernel=True)
    ops.reset_launches()
    got, cache = mamba.mamba_apply(tp, cfg, _t(x))
    assert cache is None and sum(ops.LAUNCHES.values()) == 0
    _close(got, want, CHUNKS_DIFFER)


def test_mamba_apply_prefill_then_decode_matches_reference(mixer):
    """A 7-row prefill into a zero cache, then four one-row steps: the
    outputs and the conv and SSM states match the reference's at every
    step (the reference's kernel branch drops a cached state, which is
    zero here, so both branches agree)."""
    jcfg, jp, cfg, tp = mixer
    rng = np.random.RandomState(7)
    b = 2
    jc = jmamba.init_cache(jcfg, b)
    jc["index"] = jnp.zeros((b,), jnp.int32)
    tc = dict(mamba.init_cache(cfg, b, "cpu", torch.float32),
              index=torch.zeros(b, dtype=torch.int32))
    for length in (7, 1, 1, 1, 1):
        x = rng.randn(b, length, cfg.d_model).astype(np.float32)
        want, jc = jmamba.mamba_apply(jp, jcfg, jnp.asarray(x), cache=jc,
                                      use_kernel=True)
        got, tc = mamba.mamba_apply(tp, cfg, _t(x), cache=tc)
        _close(got, want)
        for name in ("conv", "ssm"):
            _close(tc[name], jc[name])
        assert tc["index"].tolist() == np.asarray(jc["index"]).tolist()


def test_prefill_continues_from_a_cached_state(mixer):
    """l > 1 with a non-zero cached state: the port starts the scan from
    it, which is what the reference's plain branch (``ssd_chunked`` with
    h0) computes. The reference's kernel branch starts from zeros instead
    (ROADMAP Queue 3); the port does not copy that."""
    jcfg, jp, cfg, tp = mixer
    rng = np.random.RandomState(8)
    b = 2
    conv = rng.randn(b, cfg.d_conv - 1, cfg.n_heads, cfg.head_dim) \
        .astype(np.float32)
    ssm = rng.randn(b, cfg.n_heads, cfg.head_dim, cfg.d_state) \
        .astype(np.float32)
    idx = np.full((b,), 5, np.int32)
    x = rng.randn(b, 6, cfg.d_model).astype(np.float32)
    jc = {"conv": jnp.asarray(conv), "ssm": jnp.asarray(ssm),
          "index": jnp.asarray(idx)}
    want, wc = jmamba.mamba_apply(jp, jcfg, jnp.asarray(x), cache=jc,
                                  use_kernel=False)
    got, gc = mamba.mamba_apply(tp, cfg, _t(x), cache={
        "conv": _t(conv), "ssm": _t(ssm), "index": _t(idx)})
    _close(got, want)
    _close(gc["ssm"], wc["ssm"])
    dropped, _ = jmamba.mamba_apply(jp, jcfg, jnp.asarray(x), cache=jc,
                                    use_kernel=True)
    assert np.abs(np.asarray(dropped) - np.asarray(want)).max() > 1e-3


@pytest.fixture(scope="module")
def bridged():
    jcfg = dataclasses.replace(jconfigs.get_smoke("mamba2-370m"),
                               use_ssd_kernel=True)
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
    cfg = configs.get_smoke("mamba2-370m")
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                             device="cpu")
    return jcfg, jparams, cfg, params


def test_bridge_and_init_keep_the_mamba_layout(bridged):
    jcfg, jparams, cfg, params = bridged
    stacked = jparams["blocks"][0]
    assert len(params["blocks"]) == cfg.n_layers
    for i, blk in enumerate(params["blocks"]):
        assert set(blk) == {"ln1", "mamba"}          # d_ff == 0: no MLP
        for name in ("w_x", "w_ssm_out", "A_log", "conv_w"):
            np.testing.assert_array_equal(
                blk["mamba"][name].numpy(),
                np.asarray(stacked["mamba"][name][i]))
        for name in ("A_log", "D", "dt_bias"):
            assert blk["mamba"][name].dtype == torch.float32
    mine = T.init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    for blk_m, blk_b in zip(mine["blocks"], params["blocks"]):
        assert {k: tuple(v.shape) for k, v in blk_m["mamba"].items()
                if k != "norm"} == \
            {k: tuple(v.shape) for k, v in blk_b["mamba"].items()
             if k != "norm"}
        for name in ("A_log", "D", "dt_bias"):
            torch.testing.assert_close(blk_m["mamba"][name],
                                       blk_b["mamba"][name])
    jcfg_moe = dataclasses.replace(cfg, pattern=("mamba", "attn"),
                                   n_layers=2)
    with pytest.raises(ValueError, match="stacked pattern positions"):
        params_from_jax(jax.tree.map(np.asarray, jparams), jcfg_moe,
                        device="cpu")


@pytest.mark.parametrize("length", [11, 128, 131])
def test_smoke_logits_match_reference(bridged, length):
    jcfg, jparams, cfg, params = bridged
    tokens = np.random.RandomState(length).randint(
        0, cfg.vocab, size=(2, length)).astype(np.int32)
    want, _, _ = JT.forward(jparams, jcfg, jnp.asarray(tokens))
    got, _ = T.forward(params, cfg, torch.from_numpy(tokens))
    _close(got, want, CHUNKS_DIFFER)


def test_smoke_logits_through_caches_match_reference(bridged):
    """Prefill 13 rows into contiguous caches, then two decode steps: the
    logits and every layer's state match ``JT.forward`` with caches."""
    jcfg, jparams, cfg, params = bridged
    rng = np.random.RandomState(2)
    jc = JT.init_caches(jcfg, 2, 32)
    tc = T.init_caches(cfg, 2, 32, device="cpu")
    for length in (13, 1, 1):
        tokens = rng.randint(0, cfg.vocab, size=(2, length)).astype(np.int32)
        want, jc, _ = JT.forward(jparams, jcfg, jnp.asarray(tokens),
                                 caches=jc)
        got, tc = T.forward(params, cfg, torch.from_numpy(tokens), caches=tc)
        _close(got, want)
    for layer, c in enumerate(tc):
        _close(c["ssm"], jc[0]["ssm"][layer])
        assert int(c["index"]) == int(jc[0]["index"][layer]) == 15
