"""The last of the reference's public API the port lacked, each held to
the reference on the CPU: ``PageAllocator.occupancy(lengths)`` and
``reset()``, ``MoEConfig.router_dtype``, ``sdpa(kv_lengths=)``,
``causal_mask(sq, skv, offset)``, ``transformer.param_count(cfg)``,
``configs.list_archs()`` and the launchers' ``--arch`` under either name.

Tolerances: the allocator, the masks, the counts and the names are exact.
The router in bf16 is too: both sides round the logits, each softmax step
and the top-k weights' sum in bf16 and break ties to the lower expert, so
ids, weights and the aux loss come out bit-equal (the test asserts
equality; a bf16 step, 2^-8 of a weight, would be the loosest fair
limit); in fp32 the ids are equal and the weights within 1e-6 (sums in
another order, weights below 1). ``sdpa`` in fp32 is held at 1e-5
absolute (outputs O(1), only the order of sums differs), in bf16 at two
bf16 roundings (2^-7) of the output's largest magnitude, as
``test_torch_attn_knobs.py`` holds it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import layers as JL
from repro.models import moe as jmoe
from repro.models import transformer as JT
from repro.serve import paged as jpaged

from repro_torch import configs
from repro_torch.launch import profile as profile_launch
from repro_torch.launch import serve as serve_launch
from repro_torch.launch import train as train_launch
from repro_torch.models import layers, moe
from repro_torch.models import transformer as T
from repro_torch.serve import paged

FP32_TOL = 1e-5
BF16_OUT_ULPS = 2.0 ** -7


# ----------------------------------------------------------------------------
# PageAllocator
# ----------------------------------------------------------------------------

def test_occupancy_and_fragmentation_accounting():
    """The reference's own case (``tests/test_paged_kv.py``), on the
    port's allocator and the reference's side by side."""
    for al in (paged.PageAllocator(n_pages=9, page_size=8),
               jpaged.PageAllocator(n_pages=9, page_size=8)):
        al.alloc(0, 2)                        # 16 rows allocated
        al.alloc(1, 1)                        # 8 rows allocated
        occ = al.occupancy({0: 9, 1: 8})
        assert occ["pages_in_use"] == 3
        assert occ["rows_resident"] == 4 * 8  # + null page
        assert occ["fragmentation_rows"] == 24 - 17
        assert occ["fragmentation_frac"] == pytest.approx(7 / 24)
        assert occ["high_water"] == 3
        assert occ["utilization"] == pytest.approx(3 / 8)


@pytest.mark.parametrize("n_devices", [1, 2])
def test_occupancy_equals_the_references(n_devices):
    """Every key and value of the report, with and without lengths, after
    allocations, a share, an index hold, a copy-on-write and a free."""
    pools = [mod.PageAllocator(n_pages=16, page_size=4, n_devices=n_devices)
             for mod in (paged, jpaged)]
    for al in pools:
        al.alloc(0, 3)
        al.alloc(1, 2)
        al.share(2, al.slot_pages[0][:2])
        al.retain(al.slot_pages[1][0])
        al.cow(2, 1)
        al.free_slot(1)
    lengths = {0: 11, 2: 6}
    assert pools[0].occupancy() == pools[1].occupancy()
    assert pools[0].occupancy(lengths) == pools[1].occupancy(lengths)
    assert pools[0].occupancy({})["fragmentation_rows"] == 4 * (3 + 2)
    assert "fragmentation_rows" not in pools[0].occupancy()


def test_reset_frees_everything_like_the_references():
    """``reset()`` after churn: the pool hands out the same pages in the
    same order as a new one, with zeroed counters, as the reference's."""
    pools = [mod.PageAllocator(n_pages=12, page_size=8, n_devices=2)
             for mod in (paged, jpaged)]
    fresh = paged.PageAllocator(n_pages=12, page_size=8, n_devices=2)
    for al in pools:
        al.alloc(0, 4)
        al.share(1, al.slot_pages[0][:1])
        al.retain(al.slot_pages[0][2])
        al.reset()
    assert pools[0].occupancy() == pools[1].occupancy() == fresh.occupancy()
    assert pools[0].slot_pages == {} and pools[0].free_pages == 11
    assert pools[0].alloc(3, 5) == pools[1].alloc(3, 5) == fresh.alloc(3, 5)


# ----------------------------------------------------------------------------
# MoEConfig.router_dtype
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_router_dtype_routes_like_the_reference(seed, dtype):
    """The dbrx smoke's router in bf16 and in fp32: ids equal to the
    reference's; weights and aux bit-equal in bf16 (the logits round to
    the same bf16 values), within 1e-6 in fp32 (the logits' sums run in
    another order). In bf16 a random router's probabilities tie often, so
    this also holds the tie rule."""
    jc = jconfigs.get_smoke("dbrx-132b")
    kw = dict(d_model=jc.d_model, d_ff=jc.d_ff, n_experts=jc.n_experts,
              top_k=jc.top_k)
    jcfg = jmoe.MoEConfig(**kw, router_dtype=getattr(jnp, dtype))
    cfg = moe.MoEConfig(**kw, router_dtype=getattr(torch, dtype))
    jp = jmoe.moe_init(jax.random.PRNGKey(seed), jcfg)
    x = np.random.RandomState(seed).randn(64, jc.d_model).astype(np.float32)
    w, ids, aux = jmoe._route(jp, jcfg, jnp.asarray(x))
    tw, tids, taux = moe._route(
        {"router": torch.from_numpy(np.array(jp["router"]))}, cfg,
        torch.from_numpy(x))
    assert np.array_equal(tids.numpy(), np.asarray(ids))
    if dtype == "bfloat16":
        assert np.array_equal(tw.numpy(), np.asarray(w))
        assert float(taux) == float(aux)
    else:
        np.testing.assert_allclose(tw.numpy(), np.asarray(w), atol=1e-6)
        assert float(taux) == pytest.approx(float(aux), abs=1e-6)


def test_router_dtype_defaults_to_fp32_as_the_reference():
    assert moe.MoEConfig(1, 1, 2, 1).router_dtype == torch.float32
    assert jmoe.MoEConfig(1, 1, 2, 1).router_dtype == jnp.float32


def test_bf16_router_ties_go_to_the_lower_expert():
    """Two experts whose bf16 probabilities tie: the lower index wins, as
    ``jax.lax.top_k`` breaks ties."""
    cfg = moe.MoEConfig(d_model=2, d_ff=1, n_experts=4, top_k=1,
                        router_dtype=torch.bfloat16)
    router = torch.tensor([[0.0, 1.0, 1.0, 0.5], [0.0, 0.0, 0.0, 0.0]])
    _, ids, _ = moe._route({"router": router}, cfg,
                           torch.tensor([[1.0, 0.0]]))
    assert ids.tolist() == [[1]]


def test_fp32_router_ties_go_to_the_lower_expert():
    """The fp32 router (the fused softmax) keeps the same tie rule: a zero
    router ties every expert, and the lowest ones win, in order."""
    cfg = moe.MoEConfig(d_model=2, d_ff=1, n_experts=8, top_k=3)
    w, ids, _ = moe._route({"router": torch.zeros(2, 8)}, cfg,
                           torch.ones(5, 2))
    assert ids.tolist() == [[0, 1, 2]] * 5
    assert torch.equal(w, torch.full((5, 3), 1 / 3))


# ----------------------------------------------------------------------------
# sdpa(kv_lengths=) and causal_mask(sq, skv, offset)
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sdpa_masks_by_kv_lengths_like_the_reference(dtype, masked):
    """b 3 queries of 4 rows over a 40-row cache, GQA 8 over 2, the rows
    at or past each slot's length masked (40, 17 and 1), with and
    without a causal mask at offset 36 on top."""
    rng = np.random.RandomState(1)
    b, sq, skv, h, kvh, d = 3, 4, 40, 8, 2, 64
    q = rng.randn(b, sq, h, d).astype(np.float32)
    k = rng.randn(b, skv, kvh, d).astype(np.float32)
    v = rng.randn(b, skv, kvh, d).astype(np.float32)
    lens = np.array([40, 17, 1], np.int32)
    jmask = JL.causal_mask(sq, skv, skv - sq) if masked else None
    tmask = layers.causal_mask(sq, skv, skv - sq) if masked else None
    want = JL.sdpa(*(jnp.asarray(a, getattr(jnp, dtype)) for a in (q, k, v)),
                   mask=jmask, kv_lengths=jnp.asarray(lens))
    got = layers.sdpa(*(torch.from_numpy(a).to(getattr(torch, dtype))
                        for a in (q, k, v)),
                      mask=tmask, kv_lengths=torch.from_numpy(lens))
    want = np.asarray(want.astype(jnp.float32))
    err = float(np.abs(got.float().numpy() - want).max())
    tol = FP32_TOL if dtype == "float32" else \
        BF16_OUT_ULPS * float(np.abs(want).max())
    assert err <= tol
    # Slot 2 sees its first row alone: each head's output is that row's V
    # of its kv head.
    row = torch.from_numpy(v[2, 0]).to(getattr(torch, dtype)).float()
    want_row = row.repeat_interleave(h // kvh, dim=0)           # (h, d)
    assert float((got[2].float() - want_row).abs().max()) <= tol


@pytest.mark.parametrize("sq,skv,offset", [(5, None, 0), (4, 9, 5),
                                           (6, 6, 2), (3, 8, 0)])
def test_causal_mask_equals_the_references(sq, skv, offset):
    want = np.asarray(JL.causal_mask(sq, skv, offset))
    got = layers.causal_mask(sq, skv, offset)
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), want)


# ----------------------------------------------------------------------------
# param_count(cfg), list_archs(), the launchers' --arch
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("arch", jconfigs.list_archs())
def test_param_count_takes_a_config_like_the_references(arch):
    """Every registry smoke: the port's count from the config equals the
    reference's, and the leaves ``init_params`` draws."""
    cfg = configs.get_smoke(arch)
    assert T.param_count(cfg) == JT.param_count(jconfigs.get_smoke(arch))
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="meta", dtype=torch.float32)
    assert T.tree_param_count(params) == T.param_count(cfg)


def test_list_archs_equals_the_references():
    assert configs.list_archs() == jconfigs.list_archs()
    assert configs.ARCHS == jconfigs.ARCHS
    for name in configs.list_archs():
        assert configs.canonical_id(name) == jconfigs.canonical_id(name)
        assert configs.get_config(name) == \
            configs.get_config(configs.canonical_id(name))


class _Stop(Exception):
    pass


@pytest.mark.parametrize("name", ["qwen3-4b", "qwen3_4b"])
@pytest.mark.parametrize("launcher", ["serve", "train", "profile"])
def test_launchers_take_either_name(launcher, name, monkeypatch, tmp_path):
    """``--arch`` takes the CLI id or its module's name (what
    ``list_archs`` returns) and hands the registry the CLI id; an unknown
    name is refused by the parser."""
    seen = []

    def stop(arch):
        seen.append(arch)
        raise _Stop

    monkeypatch.setattr(configs, "get_smoke", stop)
    monkeypatch.setattr(configs, "get_config", stop)
    monkeypatch.setattr(profile_launch, "resolve_device", lambda d: "cpu")
    main, extra = {
        "serve": (serve_launch.main, ["--smoke", "--device", "cpu"]),
        "train": (train_launch.main, ["--smoke", "--device", "cpu",
                                      "--ckpt", str(tmp_path)]),
        "profile": (profile_launch.main, []),
    }[launcher]
    with pytest.raises(_Stop):
        main(["--arch", name, *extra])
    assert seen == ["qwen3-4b"]
    with pytest.raises(SystemExit):
        main(["--arch", "qwen9-1b", *extra])
