"""Mixture-of-experts MLP of the PyTorch port against the reference's
``repro/models/moe.py``: routing, the dense-mask and capacity paths, the
shared expert and the auxiliary load-balancing loss.

Inputs are numpy arrays from a seed; the parameters are the reference's
``moe_init`` carried across through numpy. Tolerance: 1e-5 absolute plus
1e-5 relative in fp32 for the output and the aux loss. Both sides route
in fp32 and run the same products; only the order of sums differs (XLA's
CPU dot and scatter-add against torch's matmul and a sum over k), and the
activations are O(1). A dropped (token, expert) choice moves a token's
output by O(1), so output equality at that tolerance also says that the
same choices were dropped; the count of drops is checked besides.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe

from repro_torch.models import moe

ATOL = RTOL = 1e-5
D, F, E = 16, 24, 8
B, S = 3, 5                       # t = 15 tokens


def _torch_params(jp):
    return {k: _torch_params(v) if isinstance(v, dict)
            else torch.from_numpy(np.array(v)) for k, v in jp.items()}


def _configs(top_k, n_shared, impl, factor=1.25):
    kw = dict(d_model=D, d_ff=F, n_experts=E, top_k=top_k, n_shared=n_shared,
              capacity_factor=factor, impl=impl)
    return jmoe.MoEConfig(**kw), moe.MoEConfig(**kw)


def _case(top_k, n_shared, impl, factor=1.25, seed=0):
    jcfg, cfg = _configs(top_k, n_shared, impl, factor)
    jp = jmoe.moe_init(jax.random.PRNGKey(seed), jcfg)
    x = np.random.RandomState(seed + 1).randn(B, S, D).astype(np.float32)
    return jcfg, jp, cfg, _torch_params(jax.tree.map(np.asarray, jp)), x


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=RTOL)


def _reference_drops(jp, jcfg, x) -> int:
    """Choices past their expert's capacity, from the reference's own
    routing (its ids) and its capacity formula."""
    _, ids, _ = jmoe._route(jp, jcfg, jnp.asarray(x.reshape(-1, D)))
    counts = np.bincount(np.asarray(ids).reshape(-1), minlength=E)
    t = B * S
    cap = max(int(np.ceil(t * jcfg.top_k / E * jcfg.capacity_factor)), 4)
    return int(np.maximum(counts - cap, 0).sum())


@pytest.mark.parametrize("impl", ["dense_mask", "capacity"])
@pytest.mark.parametrize("n_shared", [0, 1])
@pytest.mark.parametrize("top_k", [1, 2, 4])
def test_moe_apply_matches_reference(top_k, n_shared, impl):
    jcfg, jp, cfg, params, x = _case(top_k, n_shared, impl)
    want, want_aux = jmoe.moe_apply(jp, jcfg, jnp.asarray(x))
    got, aux = moe.moe_apply(params, cfg, torch.from_numpy(x))
    assert got.shape == (B, S, D) and got.dtype == torch.float32
    _close(got, want)
    _close(aux, want_aux)
    assert set(params) == {"router", "expert_gate", "expert_up",
                           "expert_down"} | ({"shared"} if n_shared else set())


@pytest.mark.parametrize("n_shared", [0, 1])
@pytest.mark.parametrize("top_k", [1, 2, 4])
def test_capacity_drops_the_reference_choices(top_k, n_shared):
    """At a capacity factor of 0.25 most experts overflow: the port drops
    as many choices as the reference's routing and capacity say, and the
    outputs agree, so the same choices went."""
    jcfg, jp, cfg, params, x = _case(top_k, n_shared, "capacity",
                                     factor=0.25, seed=top_k)
    want, want_aux = jmoe.moe_apply(jp, jcfg, jnp.asarray(x))
    got, aux = moe.moe_apply(params, cfg, torch.from_numpy(x))
    _close(got, want)
    _close(aux, want_aux)
    n_dropped = int(moe.dropped(params, cfg, torch.from_numpy(x)))
    assert n_dropped == _reference_drops(jp, jcfg, x)
    if top_k > 1:
        assert n_dropped > 0


@pytest.mark.parametrize("top_k", [1, 2, 4])
def test_paths_agree_at_a_generous_capacity(top_k):
    """With room for every choice the capacity path is the dense-mask
    path, as ``tests/test_moe_mamba.py`` holds the reference's."""
    _, _, cfg, params, x = _case(top_k, 1, "capacity", factor=float(E))
    dense = dataclasses.replace(cfg, impl="dense_mask")
    assert int(moe.dropped(params, cfg, torch.from_numpy(x))) == 0
    a, aux_a = moe.moe_apply(params, cfg, torch.from_numpy(x))
    b, aux_b = moe.moe_apply(params, dense, torch.from_numpy(x))
    torch.testing.assert_close(a, b, atol=ATOL, rtol=RTOL)
    assert float(aux_a) == float(aux_b)


@pytest.mark.parametrize("t", [1, 8, 15, 256, 2048])
@pytest.mark.parametrize("top_k,experts,factor", [(4, 16, 1.25),
                                                  (1, 128, 1.25),
                                                  (2, 16, 0.25)])
def test_capacity_is_the_reference_formula(t, top_k, experts, factor):
    cfg = moe.MoEConfig(d_model=D, d_ff=F, n_experts=experts, top_k=top_k,
                        capacity_factor=factor, impl="capacity")
    assert moe.capacity(cfg, t) == max(
        int(np.ceil(t * top_k / experts * factor)), 4)


def test_router_routes_in_fp32_and_outputs_keep_the_dtype():
    """bf16 activations: the router and its softmax in fp32 (the router
    weight stays fp32), the gate weights cast to bf16, a bf16 output."""
    _, _, cfg, params, x = _case(2, 1, "capacity")
    bf = {k: (v if k == "router" else
              {n: w.to(torch.bfloat16) for n, w in v.items()}
              if isinstance(v, dict) else v.to(torch.bfloat16))
          for k, v in params.items()}
    xb = torch.from_numpy(x).to(torch.bfloat16)
    out, aux = moe.moe_apply(bf, cfg, xb)
    assert out.dtype == torch.bfloat16 and aux.dtype == torch.float32
    weights, ids, _ = moe._route(bf, cfg, xb.reshape(-1, D))
    assert weights.dtype == torch.bfloat16 and ids.dtype == torch.int64
    probs = torch.softmax(xb.reshape(-1, D).float() @ params["router"], -1)
    assert torch.equal(ids, torch.topk(probs, 2, dim=-1).indices)


def test_init_draws_the_reference_shapes_and_scales():
    """``moe_init`` draws the reference's shapes and standard deviations:
    the router 0.02 (fp32), the experts' gate and up 1/sqrt(n_experts)
    (``layers._init``'s default scale), down 1/sqrt(f), the shared
    expert's projections 1/sqrt(fan_in)."""
    cfg = moe.MoEConfig(d_model=64, d_ff=96, n_experts=16, top_k=4,
                        n_shared=1)
    p = moe.moe_init(torch.Generator().manual_seed(0), cfg, "cpu",
                     torch.bfloat16)
    jp = jmoe.moe_init(jax.random.PRNGKey(0), jmoe.MoEConfig(
        d_model=64, d_ff=96, n_experts=16, top_k=4, n_shared=1))
    for name in ("router", "expert_gate", "expert_up", "expert_down"):
        assert tuple(p[name].shape) == np.asarray(jp[name]).shape
        want = float(np.asarray(jp[name]).std())
        assert abs(float(p[name].float().std()) / want - 1) < 0.1, name
    assert p["router"].dtype == torch.float32
    assert p["expert_gate"].dtype == torch.bfloat16
    for name, w in p["shared"].items():
        assert tuple(w.shape) == np.asarray(jp["shared"][name]).shape
        want = float(np.asarray(jp["shared"][name]).std())
        assert abs(float(w.float().std()) / want - 1) < 0.1, name
