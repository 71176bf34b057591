"""The tensor-parallel rules and models of the PyTorch port against the
reference, with no process group: the sharding rules
(``dist/sharding.py``), the device-sharded ``PageAllocator``, the
interconnect model, and the serving cost models' tensor-parallel terms.

* ``param_spec`` and ``Ruleset.spec`` equal the reference's for every
  leaf of every registry configuration (the reference's leaf shapes from
  ``jax.eval_shape`` of its ``init_params``, stacked over periods, and
  the same shapes with the period dim dropped, the port's layout) on
  meshes of 1, 2, 4 and 8 model ranks, with and without a data axis of 2
  and FSDP; ``local_shard`` cuts the block a spec names.
* ``PageAllocator(n_devices=N)`` hands out the reference's page ids under
  a seeded churn of allocations, copy-on-write and frees, with the same
  ``device_of``, ``local_of``, occupancy a device and free lists.
* ``interconnect.collective_time``, ``_tp_collective_s``, ``_tp_shard``
  and ``choose_layer_sharding`` equal the reference's under the same
  constants: each of the paper's three links (Table 5.1) as the
  reference's ICI link (``TPUSpec`` with one link an axis), and the
  H100's bf16 peak. ``tp_decode_model``'s attention terms price the
  port's own kernels, so it is held by its properties and by its
  collective term.

Exact equality throughout, except the float models (rtol 1e-12: the same
formulas in the same order).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro import configs as jconfigs
from repro.core import autotune as jautotune
from repro.core import hwmodel as jhwmodel
from repro.core import interconnect as jinterconnect
from repro.dist import sharding as jsharding
from repro.models import transformer as JT
from repro.serve import paged as jpaged

from repro_torch.core import autotune, hwmodel, interconnect
from repro_torch.dist import sharding
from repro_torch.serve import paged

RTOL = 1e-12


class _Mesh:
    """A stub mesh: axis sizes, and this rank's coordinates."""

    def __init__(self, shape, coords=None):
        self.shape = dict(shape)
        self._coords = coords or {a: 0 for a in shape}

    def index(self, axis):
        return self._coords[axis]


MESHES = [({"model": n}, fsdp) for n in (1, 2, 4, 8) for fsdp in (False,)] \
    + [({"data": 2, "model": n}, fsdp) for n in (1, 2, 4, 8)
       for fsdp in (False, True)]


def _leaves(arch):
    """(path names, shape) of every leaf of the reference's params."""
    cfg = jconfigs.get_config(arch)
    tree = jax.eval_shape(lambda: JT.init_params(jax.random.PRNGKey(0), cfg))
    out = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        names = tuple(str(getattr(p, "key", getattr(p, "idx", p)))
                      for p in path)
        out.append((names, tuple(leaf.shape)))
        if names[0] in ("blocks", "encoder") and len(leaf.shape) > 1:
            out.append((names, tuple(leaf.shape[1:])))   # one layer's
    return out


@pytest.mark.parametrize("arch", jconfigs.list_archs())
def test_param_spec_matches_reference_on_every_leaf(arch):
    leaves = _leaves(arch)
    assert leaves
    for shape, fsdp in MESHES:
        rs = sharding.Ruleset(mesh=_Mesh(shape), fsdp=fsdp)
        jrs = jsharding.Ruleset(mesh=_Mesh(shape), fsdp=fsdp)
        for names, leaf_shape in leaves:
            want = tuple(jsharding.param_spec(names, leaf_shape, jrs))
            got = sharding.param_spec(names, leaf_shape, rs)
            assert got == want, (names, leaf_shape, shape, fsdp)


@pytest.mark.parametrize("rules", [{}, {"cache_seq": "data"},
                                   {"heads": ("data", "model")}])
def test_activation_specs_and_rules_match_reference(rules):
    names = ("batch", "seq", "heads", "head_dim")
    for shape in ({"model": 4}, {"data": 2, "model": 4},
                  {"pod": 2, "data": 2, "model": 2}):
        rs = sharding.Ruleset(mesh=_Mesh(shape), rules=rules)
        jrs = jsharding.Ruleset(mesh=_Mesh(shape), rules=rules)
        for dims in ((8, 16, 32, 64), (6, 16, 6, 64), (4, 3, 8, 80)):
            assert rs.spec(names, dims) == tuple(jrs.spec(names, dims))
            for cache in (("batch", "cache_seq", "kv_heads", None),):
                assert rs.spec(cache, dims) == tuple(jrs.spec(cache, dims))


def test_ambient_ruleset_is_reentrant():
    outer = sharding.Ruleset(mesh=_Mesh({"model": 2}))
    inner = sharding.Ruleset(mesh=None)
    assert sharding.current_ruleset() is None
    with sharding.use_ruleset(outer):
        with sharding.use_ruleset(inner):
            assert sharding.current_ruleset() is inner
        assert sharding.current_ruleset() is outer
    assert sharding.current_ruleset() is None


def test_sharded_reads_the_divisibility_rule():
    rs = sharding.Ruleset(mesh=_Mesh({"model": 4}))
    assert rs.sharded("heads", 32) == "model"
    assert rs.sharded("kv_heads", 2) is None        # replicated
    assert rs.sharded("embed", 2560) is None        # no rule
    composed = sharding.Ruleset(mesh=_Mesh({"data": 2, "model": 2}),
                                rules={"heads": ("data", "model")})
    with pytest.raises(ValueError, match="single mesh axis"):
        composed.sharded("heads", 8)


@pytest.mark.parametrize("coords", [{"data": 1, "model": 2},
                                    {"data": 0, "model": 3}])
def test_local_shard_cuts_the_named_block(coords):
    mesh = _Mesh({"data": 2, "model": 4}, coords)
    x = torch.arange(8 * 6 * 4).reshape(8, 6, 4)
    got = sharding.local_shard(x, ("model", None, "data"), mesh)
    m, d = coords["model"], coords["data"]
    assert torch.equal(got, x[2 * m:2 * m + 2, :, 2 * d:2 * d + 2])
    both = sharding.local_shard(x, (("data", "model"), None, None), mesh)
    i = d * 4 + m
    assert torch.equal(both, x[i:i + 1])
    assert got.is_contiguous()


# ----------------------------------------------------------------------------
# The device-sharded page allocator
# ----------------------------------------------------------------------------

def _state(pool):
    return (pool._free, pool.free_pages, pool.pages_in_use,
            pool.device_occupancy(), pool.capacity, pool.block,
            pool.pages_allocated, pool.pages_freed, pool.cow_count,
            pool.high_water)


@pytest.mark.parametrize("d", [1, 2, 4, 8])
def test_capacity_and_first_pages_match_reference(d):
    pool = paged.PageAllocator(n_pages=16, page_size=4, n_devices=d)
    ref = jpaged.PageAllocator(n_pages=16, page_size=4, n_devices=d)
    assert pool.capacity == ref.capacity == 15
    assert pool.alloc(0, 7) == ref.alloc(0, 7)
    assert _state(pool) == _state(ref)
    assert pool.occupancy() == ref.occupancy()


def test_pages_must_split_over_the_devices():
    with pytest.raises(ValueError, match="do not split"):
        paged.PageAllocator(n_pages=10, page_size=4, n_devices=4)


@given(d=st.sampled_from([1, 2, 4, 8]), seed=st.integers(0, 1000))
@settings(max_examples=40, deadline=None)
def test_sharded_allocator_churn_matches_reference(d, seed):
    """The same admit, share, copy-on-write and free churn through both
    allocators: every page id, owner device and local index equal, and
    the occupancy a device summing to the pages in use."""
    rng = np.random.RandomState(seed)
    pool = paged.PageAllocator(n_pages=8 * d, page_size=4, n_devices=d)
    ref = jpaged.PageAllocator(n_pages=8 * d, page_size=4, n_devices=d)
    for _ in range(120):
        rid = int(rng.randint(0, 6))
        r = rng.rand()
        if r < 0.55 and pool.free_pages:
            n = int(rng.randint(1, min(4, pool.free_pages) + 1))
            got, want = pool.alloc(rid, n), ref.alloc(rid, n)
            assert got == want
            for p in got:
                assert p != paged.NULL_PAGE
                assert (pool.device_of(p), pool.local_of(p)) == \
                    (ref.device_of(p), ref.local_of(p))
                assert 0 <= pool.local_of(p) < pool.block
        elif r < 0.7 and pool.slot_pages.get(rid) and pool.free_pages:
            other = (rid + 1) % 6
            pages = pool.slot_pages[rid][:1]
            pool.share(other, pages)
            ref.share(other, pages)
            assert pool.cow(other, len(pool.slot_pages[other]) - 1) == \
                ref.cow(other, len(ref.slot_pages[other]) - 1)
        elif rid in pool.slot_pages:
            assert pool.free_slot(rid) == ref.free_slot(rid)
        assert _state(pool) == _state(ref)
        assert sum(pool.device_occupancy()) == pool.pages_in_use


# ----------------------------------------------------------------------------
# Interconnect and the tensor-parallel cost terms
# ----------------------------------------------------------------------------

def _tpu_like(link, links=1):
    """The reference's TPU record carrying a paper link as its ICI link
    (``links`` an axis: it gives an axis half its chip's links) and the
    H100's bf16 peak."""
    return dataclasses.replace(
        jhwmodel.DEFAULT_TPU, ici_link_bandwidth=link.unidir_gbs * 1e9,
        ici_latency_us=link.latency_us, ici_links_per_chip=2 * links,
        peak_bf16_flops=hwmodel.H100.peak_bf16_flops)


PAPER_LINKS = list(hwmodel.LINKS.values())


@pytest.mark.parametrize("link", PAPER_LINKS, ids=lambda l: l.name)
@pytest.mark.parametrize("kind", ["all_reduce", "all_gather",
                                  "reduce_scatter", "all_to_all",
                                  "collective_permute"])
def test_collective_time_matches_reference(link, kind):
    tpu = _tpu_like(link)
    for n in (1, 2, 4, 8):
        for payload in (4096, 3 * 2 ** 20, 1e9):
            got = interconnect.collective_time(kind, payload, n, link,
                                               links=1)
            want = jinterconnect.collective_time(kind, payload, n, tpu)
            for f in ("bytes_on_wire", "time_s", "alpha_s", "beta_s"):
                np.testing.assert_allclose(getattr(got, f),
                                           getattr(want, f), rtol=RTOL)
    assert interconnect._ring_factor("broadcast", 4) == 1.0


def test_links_match_the_paper_and_name_the_h100():
    assert {n: (l.unidir_gbs, l.latency_us, l.theoretical_gbs)
            for n, l in hwmodel.LINKS.items()} == \
        {n: (l.unidir_gbs, l.latency_us, l.theoretical_gbs)
         for n, l in jhwmodel.LINKS.items()}
    assert hwmodel.HOST_BANDWIDTH_MBS == jhwmodel.HOST_BANDWIDTH_MBS
    assert interconnect.measured_vs_theoretical() == \
        jinterconnect.measured_vs_theoretical()
    rows = interconnect.link_comparison()
    want = jinterconnect.link_comparison()
    assert "TPU-ICI-link" not in rows
    assert {k: v for k, v in rows.items() if k in hwmodel.LINKS} == \
        {k: v for k, v in want.items() if k in jhwmodel.LINKS}
    nv = hwmodel.H100_NVLINK4
    assert rows["H100-NVLink4"] == (25.0, nv.latency_us)
    assert nv.links * nv.unidir_gbs * 2 == 900.0     # the data sheet's


@pytest.mark.parametrize("link", PAPER_LINKS, ids=lambda l: l.name)
def test_tp_terms_match_reference(link):
    tpu = _tpu_like(link)
    for n in (1, 2, 4, 8):
        tp = autotune.TPServe(n_devices=n, d_model=2560, n_layers=36)
        jtp = jautotune.TPServe(n_devices=n, d_model=2560, n_layers=36)
        for tokens in (1, 8, 512):
            np.testing.assert_allclose(
                autotune._tp_collective_s(tokens, tp, 2, link=link),
                jautotune._tp_collective_s(tokens, jtp, 2, tpu), rtol=RTOL)
        for heads in (8, 6, 32):
            assert autotune._tp_shard(tp, heads) == \
                jautotune._tp_shard(jtp, heads)
    assert autotune._tp_shard(None, 8) == (1, 1)
    assert autotune._tp_collective_s(64, None, 2) == 0.0


@pytest.mark.parametrize("link", PAPER_LINKS, ids=lambda l: l.name)
def test_choose_layer_sharding_matches_reference(link):
    tpu = _tpu_like(link)
    for args in ((256, 4096, 8192, 1, 8), (8192, 2560, 9728, 2, 4),
                 (4, 2560, 151936, 1, 2)):
        got = autotune.choose_layer_sharding(*args, link=link)
        want = jautotune.choose_layer_sharding(*args, tpu=tpu)
        assert [c.name for c in got] == [c.name for c in want]
        for g, w in zip(got, want):
            for f in ("time_s", "compute_s", "collective_s"):
                np.testing.assert_allclose(getattr(g, f), getattr(w, f),
                                           rtol=RTOL)


def test_tp_decode_model_shards_the_weight_stream():
    terms = autotune.tp_decode_model(
        [4096] * 8, n_heads=32, n_kv_heads=8, head_dim=128, page_size=64,
        param_bytes=8e9, d_model=4096, n_layers=36, n_devices=8)
    assert terms["weight_stream_tp_s"] * 8 == \
        pytest.approx(terms["weight_stream_1dev_s"])
    assert terms["collective_s"] == pytest.approx(autotune._tp_collective_s(
        8, autotune.TPServe(8, 4096, 36), 2))
    assert terms["collective_s"] > 0.0
    assert terms["pool_capacity_ratio"] == 8.0
    assert terms["attn_sharded"]
    assert not autotune.tp_decode_model(
        [512] * 4, n_heads=32, n_kv_heads=8, head_dim=80, page_size=16,
        param_bytes=8e9, d_model=2560, n_layers=36,
        n_devices=16)["attn_sharded"]


def test_tp_terms_price_in_the_serving_models():
    """The chunk, decode and spec models carry a collective term under
    ``tp`` and are their one-device selves without it."""
    tp = autotune.TPServe(n_devices=8, d_model=4096, n_layers=36)
    c0 = autotune.prefill_chunk_model(2048, 256, 32, 8, 128, 64)
    c8 = autotune.prefill_chunk_model(2048, 256, 32, 8, 128, 64, tp=tp)
    assert c0["collective_s"] == 0.0 and c8["collective_s"] > 0.0
    assert c8["attn_s"] * 8 == pytest.approx(c0["attn_s"])
    d0 = autotune.paged_decode_model(4096, [1000, 2000], 32, 8, 128, 64)
    d8 = autotune.paged_decode_model(4096, [1000, 2000], 32, 8, 128, 64,
                                     tp=tp)
    assert d0["collective_s"] == 0.0 and d8["collective_s"] > 0.0
    assert d8["contig_s"] - d8["collective_s"] == \
        pytest.approx(d0["contig_s"] / 8)
    s0 = autotune.spec_decode_model([2048] * 4, 32, 8, 128, 64, k=4,
                                    accept_rate=0.8, param_bytes=8e9)
    s8 = autotune.spec_decode_model([2048] * 4, 32, 8, 128, 64, k=4,
                                    accept_rate=0.8, param_bytes=8e9, tp=tp)
    assert s8["weight_stream_s"] * 8 == pytest.approx(s0["weight_stream_s"])
    k, terms = autotune.choose_spec_k([2048] * 4, 32, 8, 128, 64, 0.8, 8e9,
                                      tp=tp)
    assert terms["chosen_k"] == k
