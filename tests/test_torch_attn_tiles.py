"""The attention wrappers' tile arguments and the tile chooser, against the
reference.

* ``ops.flash_attention`` / ``flash_attention_paged`` with ``block_q`` and
  ``block_k`` set, and ``flash_decode`` / ``flash_decode_paged`` with
  ``block_k`` set, on the CPU (their plain versions) against the
  reference's wrappers given the same arguments, its Pallas kernels in
  interpret mode, on numpy inputs from a seed, within ``ref.TOLERANCE``
  (fp32: both sides keep an fp32 online softmax and differ only in the
  order of their sums);
* the snapping rule (the largest instantiated tile not above the one
  given) and the refusal below the smallest;
* ``choose_attn_block``'s cache, as ``tests/test_autotune_attn.py`` holds
  the reference's: round trip, a torn file, a malformed entry, a hit
  outside the candidates, and single-device and mesh entries kept apart
  (``tests/test_serve_dist.py``); the in-process memo;
* the chooser beats or ties ``NAIVE_ATTN_BLOCK`` in the model,
  ``decode_attn_speedup`` is at least 1, and the serving models and
  ``kernels/cost.py`` price the tile the chooser picks;
* the launchers hand the tile to the C entries, and the graphs' kernel
  map files each new instantiation under its wrapper.

Every test that writes a cache keeps it under ``tmp_path`` through
``$REPRO_TORCH_TUNING_CACHE`` (``own_cache``).
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops

from repro_torch.core import autotune, hwmodel, op_analysis
from repro_torch.kernels import _build, cost, ops, ref
from repro_torch.kernels import flash_attention as _prefill
from repro_torch.kernels import flash_decode as _decode
from repro_torch.serve import graphs

ATOL, RTOL = ref.TOLERANCE[torch.float32]


@pytest.fixture(autouse=True)
def own_cache(tmp_path, monkeypatch):
    """The chooser's cache on a file of this test's own, named by the
    environment variable the module reads, and no memo from before."""
    path = str(tmp_path / "tuning_cache.json")
    monkeypatch.setenv(autotune.TUNING_CACHE_ENV, path)
    monkeypatch.setattr(autotune, "TUNING_CACHE_PATH", path)
    monkeypatch.setattr(autotune, "_tuning_cache", None)
    return path


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want):
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=RTOL)


# ----------------------------------------------------------------------------
# The wrappers with a tile, against the reference's with the same tile
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("block_q,block_k", [(16, 64), (64, 64), (40, 128)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_with_a_tile_matches_the_reference(block_q, block_k,
                                                           causal):
    rng = np.random.RandomState(block_q + block_k + causal)
    b, sq, skv, h, kvh, d = 2, 64, 128, 4, 2, 64
    q = rng.randn(b, sq, h, d).astype(np.float32)
    k = rng.randn(b, skv, kvh, d).astype(np.float32)
    v = rng.randn(b, skv, kvh, d).astype(np.float32)
    got = ops.flash_attention(_t(q), _t(k), _t(v), causal=causal,
                              block_q=block_q, block_k=block_k).numpy()
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal,
                                block_q=block_q, block_k=block_k)
    _close(got, want)


@pytest.mark.parametrize("block_q,block_k", [(16, 64), (64, 64), (17, 100)])
def test_paged_prefill_with_a_tile_matches_the_reference(block_q, block_k):
    """A 24-row chunk of 2 slots against an 80-row pool (head_dim 80),
    written from ragged starts through shuffled tables."""
    rng = np.random.RandomState(block_q * 3 + block_k)
    b, sq, h, kvh, d, ps, max_pages = 2, 24, 4, 2, 80, 16, 5
    n_pages = b * max_pages + 1
    kp = rng.randn(n_pages, ps, kvh, d).astype(np.float32)
    vp = rng.randn(n_pages, ps, kvh, d).astype(np.float32)
    table = rng.permutation(np.arange(1, n_pages)).reshape(
        b, max_pages).astype(np.int32)
    starts = np.asarray([0, 37], np.int32)
    q = rng.randn(b, sq, h, d).astype(np.float32)
    got = ops.flash_attention_paged(_t(q), _t(kp), _t(vp), _t(table),
                                    _t(starts), block_q=block_q,
                                    block_k=block_k).numpy()
    want = jops.flash_attention_paged(
        *(jnp.asarray(a) for a in (q, kp, vp, table, starts)),
        block_q=block_q, block_k=block_k)
    _close(got, want)


@pytest.mark.parametrize("block_k", [128, 256, 512, 300])
def test_decodes_with_a_split_match_the_reference(block_k):
    """Both decodes at head_dim 80, a group of 2, ragged lengths with a
    zero and one past the cache."""
    rng = np.random.RandomState(block_k)
    b, kvh, d, ps, max_pages = 4, 2, 80, 8, 8
    h, max_len = 2 * kvh, ps * max_pages
    lengths = np.asarray([0, 13, max_len, 70], np.int32)
    q = rng.randn(b, h, d).astype(np.float32)
    k = rng.randn(b, max_len, kvh, d).astype(np.float32)
    v = rng.randn(b, max_len, kvh, d).astype(np.float32)
    got = ops.flash_decode(_t(q), _t(k), _t(v), _t(lengths),
                           block_k=block_k).numpy()
    want = jops.flash_decode(*(jnp.asarray(a) for a in (q, k, v, lengths)),
                             block_k=block_k)
    _close(got, want)
    n_pages = b * max_pages + 1
    kp = rng.randn(n_pages, ps, kvh, d).astype(np.float32)
    vp = rng.randn(n_pages, ps, kvh, d).astype(np.float32)
    table = rng.permutation(np.arange(1, n_pages)).reshape(
        b, max_pages).astype(np.int32)
    got = ops.flash_decode_paged(_t(q), _t(kp), _t(vp), _t(table),
                                 _t(lengths), block_k=block_k).numpy()
    want = jops.flash_decode_paged(
        *(jnp.asarray(a) for a in (q, kp, vp, table, lengths)),
        block_k=block_k)
    _close(got, want)


def test_plain_path_gives_one_result_for_every_tile():
    g = torch.Generator().manual_seed(0)
    q, k = torch.randn(1, 40, 4, 64, generator=g), \
        torch.randn(1, 40, 2, 64, generator=g)
    outs = [ops.flash_attention(q, k, k, block_q=bq, block_k=bk)
            for bq in (16, 64) for bk in (64, 256)]
    assert all(torch.equal(o, outs[0]) for o in outs)
    qd, lens = q[:, 0], torch.tensor([17], dtype=torch.int32)
    outs = [ops.flash_decode(qd, k, k, lens, block_k=r)
            for r in _decode.SPLIT_ROWS_SET]
    assert all(torch.equal(o, outs[0]) for o in outs)


# ----------------------------------------------------------------------------
# The snapping rule
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("given,want", [((16, 64), (16, 64)),
                                        ((63, 64), (16, 64)),
                                        ((64, 64), (64, 64)),
                                        ((1000, 4096), (64, 64))])
def test_prefill_tile_snaps_down_to_an_instantiated_one(given, want):
    q = torch.zeros(1, 5, 4, 64)
    tile = ops.prefill_tile(q, 40, True, *given)
    assert (tile.block_q, tile.block_k) == want
    assert tile.block_q in _prefill.BLOCK_QS
    assert tile.block_k == _prefill.TILE_K


@pytest.mark.parametrize("given,want", [(128, 128), (255, 128), (256, 256),
                                        (511, 256), (512, 512),
                                        (10**6, 512)])
def test_decode_tile_snaps_down_to_an_instantiated_split(given, want):
    q = torch.zeros(2, 8, 64)
    assert ops.decode_tile(q, 2, 4096, 16, given).block_k == want


def test_a_tile_below_the_smallest_raises_on_every_path():
    g = torch.Generator().manual_seed(1)
    q, k = torch.randn(1, 8, 4, 64, generator=g), \
        torch.randn(1, 8, 2, 64, generator=g)
    lens = torch.tensor([8], dtype=torch.int32)
    table = torch.ones(1, 1, dtype=torch.int32)
    pool = torch.randn(2, 8, 2, 64, generator=g)
    calls = [
        lambda: ops.flash_attention(q, k, k, block_q=15),
        lambda: ops.flash_attention(q, k, k, block_k=32),
        lambda: ops.flash_attention_paged(q, pool, pool, table,
                                          torch.zeros(1, dtype=torch.int32),
                                          block_q=8),
        lambda: ops.flash_decode(q[:, 0], k, k, lens, block_k=127),
        lambda: ops.flash_decode_paged(q[:, 0], pool, pool, table, lens,
                                       block_k=64),
    ]
    for i, call in enumerate(calls):
        with pytest.raises(ValueError, match="below the smallest tile"):
            call()
    meta = [torch.empty_like(t, device="meta") for t in (q, k)]
    with pytest.raises(ValueError, match="below the smallest tile"):
        ops.flash_attention(meta[0], meta[1], meta[1], block_q=1)


def test_none_takes_the_choosers_tile_from_shapes_alone():
    """Shapes only: the tile of a None is the chooser's for the reference
    wrappers' problem, whatever the data (the graphed steps read nothing
    of lengths or starts on the host)."""
    q = torch.zeros(8, 5, 32, 80, dtype=torch.bfloat16)
    tile = ops.prefill_tile(q, 2048, True)
    want, _ = autotune.choose_attn_block(autotune.AttnProblem(
        sq=5, skv=2048, n_heads=32, head_dim=80, batch=8, causal=True,
        in_bytes=2))
    assert tile == want
    assert ops.prefill_tile(q, 2048, True, block_q=64).block_q == 64
    qd = torch.zeros(8, 32, 80, dtype=torch.bfloat16)
    tile = ops.decode_tile(qd, 8, 2048, 16)
    want, _ = autotune.choose_attn_block(autotune.decode_problem(
        8, 32, 8, 80, 2048, 2, 16))
    assert tile == want and tile.block_q == 16
    assert ops.decode_tile(qd, 8, 2048, 16, choose=False).block_k is None


# ----------------------------------------------------------------------------
# The launchers hand the tile to the C entries
# ----------------------------------------------------------------------------

class _FakeLib:
    def __init__(self):
        self.calls = {}

    def __getattr__(self, name):
        def call(*args):
            assert len(args) == len(_build.SIGNATURES[name]), name
            self.calls[name] = args
            return 0
        return call


@pytest.fixture
def fake_launch(monkeypatch):
    lib = _FakeLib()
    monkeypatch.setattr(_build, "load", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 0}))
    return lib


@pytest.mark.parametrize("block_q", [16, 64])
def test_prefill_launchers_pass_block_q(fake_launch, block_q):
    q = torch.zeros(2, 24, 8, 80)
    pool = torch.zeros(3, 16, 2, 80)
    table = torch.zeros(2, 4, dtype=torch.int32)
    starts = torch.zeros(2, dtype=torch.int32)
    _prefill.paged_prefill(q, pool, pool, table, starts, q, block_q)
    assert fake_launch.calls["paged_prefill"][-2] == block_q
    kv = torch.zeros(2, 24, 2, 80)
    _prefill.flash_attention(q, kv, kv, True, q, block_q)
    assert fake_launch.calls["flash_attention"][-2] == block_q


@pytest.mark.parametrize("rows,page,want", [(128, 16, (128, 16)),
                                            (512, 16, (512, 4)),
                                            (128, 48, (96, 21)),
                                            (256, 512, (512, 4))])
def test_paged_decode_passes_the_split_in_whole_pages(fake_launch, rows,
                                                      page, want):
    max_pages = 2048 // page
    q = torch.zeros(2, 8, 80)
    pool = torch.zeros(3, page, 2, 80)
    table = torch.zeros(2, max_pages, dtype=torch.int32)
    lens = torch.zeros(2, dtype=torch.int32)
    _decode.paged_decode(q, pool, pool, table, lens, q, rows)
    assert fake_launch.calls["paged_decode"][-3:-1] == want


# Kernel names as the Itanium ABI mangles the instantiations of the two
# prefill bodies at a query block of 16 (the file's anonymous namespace
# as nvcc 12.9 names it on an H100).
PA = "_ZN51_GLOBAL__N__caccf2de_18_paged_attention_cu_fed0b86b"


@pytest.mark.parametrize("name,wrapper", [
    (PA + "14prefill_kernelIfLi80ELi16ENS_11PagedLayoutEEEvPKT_S4_S4_T2_PKi"
     "ibPS2_iiif", "flash_attention_paged"),
    (PA + "18prefill_mma_kernelILi80ELi16ENS_11PagedLayoutEEEvPK13__nv_bfl"
     "oat16S4_S4_T1_PKiibPS2_iiif", "flash_attention_paged"),
    (PA + "14prefill_kernelIfLi96ELi16ENS_16ContiguousLayoutEEEvPKT_S4_S4_T"
     "2_PKiibPS2_iiif", "flash_attention"),
    (PA + "18prefill_mma_kernelILi96ELi16ENS_16ContiguousLayoutEEEvPK13__nv"
     "_bfloat16S4_S4_T1_PKiibPS2_iiif", "flash_attention")])
def test_every_block_q_instantiation_maps_to_its_wrapper(name, wrapper):
    assert graphs.wrapper_of(name) == wrapper


# ----------------------------------------------------------------------------
# The chooser's cache: the reference's contract on the port's file
# ----------------------------------------------------------------------------

def _problem(sq=1024, skv=1024, **kw):
    return autotune.AttnProblem(sq=sq, skv=skv, n_heads=8, head_dim=128,
                                **kw)


def test_tuning_cache_roundtrip(own_cache):
    p = _problem()
    cfg, terms = autotune.choose_attn_block(p)
    assert "cached" not in terms
    stored = json.load(open(own_cache))
    assert list(stored) == [autotune._cache_key(p)]
    autotune._tuning_cache = None                 # a fresh process
    cfg2, terms2 = autotune.choose_attn_block(p)
    assert cfg2 == cfg and terms2["cached"] is True
    assert terms2["time_s"] == pytest.approx(terms["time_s"])


@pytest.mark.parametrize("garbage", [
    '{"H100 SXM:dev1:sq=1024', " ", "\x00\x01binary", "null", "[1, 2, 3]",
    '"str"'])
def test_tuning_cache_recovers_from_corrupt_file(own_cache, garbage):
    with open(own_cache, "w") as f:
        f.write(garbage)
    p = _problem()
    cfg, terms = autotune.choose_attn_block(p)
    assert "cached" not in terms
    assert cfg == autotune.choose_attn_block(p, use_cache=False)[0]
    rebuilt = json.load(open(own_cache))
    assert isinstance(rebuilt, dict) and len(rebuilt) == 1


def test_tuning_cache_tolerates_malformed_entry(own_cache):
    p = _problem()
    key = autotune._cache_key(p)
    for bad in ({"block_q": 64}, "torn", {"block_q": "x", "block_k": 1,
                                          "terms": {}, "time_s": 0.0}):
        with open(own_cache, "w") as f:
            json.dump({key: bad}, f)
        autotune._tuning_cache = None
        cfg, terms = autotune.choose_attn_block(p)
        assert "cached" not in terms, bad
        assert cfg == autotune.choose_attn_block(p, use_cache=False)[0]
        assert json.load(open(own_cache))[key]["block_q"] == cfg.block_q


@pytest.mark.parametrize("kernel,stale", [(autotune.PREFILL, (32, 64)),
                                          (autotune.PREFILL, (64, 128)),
                                          (autotune.DECODE, (16, 1024))])
def test_a_hit_outside_the_candidates_is_rederived(own_cache, kernel,
                                                   stale):
    """An entry for a tile this build does not instantiate (another
    build's, or edited by hand) is re-derived and overwritten."""
    p = _problem(kernel=kernel)
    key = autotune._cache_key(p)
    with open(own_cache, "w") as f:
        json.dump({key: {"block_q": stale[0], "block_k": stale[1],
                         "time_s": 1e-9, "terms": {}}}, f)
    cfg, terms = autotune.choose_attn_block(p)
    assert "cached" not in terms
    assert cfg in autotune.candidate_attn_blocks(p)
    assert (cfg.block_q, cfg.block_k) != stale
    assert json.load(open(own_cache))[key]["block_k"] == cfg.block_k


def test_cache_keeps_single_device_and_mesh_entries_apart():
    """Counterpart of ``tests/test_serve_dist.py``'s cache-key test."""
    p = autotune.AttnProblem(sq=128, skv=512, n_heads=4, head_dim=64,
                             causal=True, in_bytes=2)
    b1, _ = autotune.choose_attn_block(p, mesh_shape="dev1")
    b8, _ = autotune.choose_attn_block(p, mesh_shape={"model": 8})
    cache = autotune._load_tuning_cache()
    keys = sorted(cache)
    assert len(keys) == 2, keys
    assert any(":dev1:" in k for k in keys), keys
    assert any(":mesh(model=8):" in k for k in keys), keys
    assert {k.split(":", 2)[2] for k in keys} == {keys[0].split(":", 2)[2]}
    assert autotune.choose_attn_block(p, mesh_shape="dev1")[0] == b1
    assert autotune.choose_attn_block(p, mesh_shape={"model": 8})[0] == b8


def test_key_names_the_card_the_kernel_and_every_field():
    p = _problem(batch=3, causal=False, in_bytes=4,
                 kernel=autotune.DECODE, page_size=16)
    key = autotune._cache_key(p, mesh_shape="dev1")
    assert key.startswith(hwmodel.H100.name + ":dev1:")
    for part in ("sq=1024", "skv=1024", "h=8", "d=128", "b=3", "causal=0",
                 "bytes=4", "kernel=decode", "page=16"):
        assert f":{part}" in key, part
    assert autotune._cache_key(dataclasses.replace(
        p, kernel=autotune.PREFILL), mesh_shape="dev1") != key


def test_hits_are_memoised_without_file_io_or_pricing(own_cache,
                                                      monkeypatch):
    p = _problem()
    autotune.choose_attn_block(p)                 # a miss, stored
    first = autotune.choose_attn_block(p)         # a hit, memoised
    assert first[1]["cached"] is True

    def refuse(*_a, **_k):
        raise AssertionError("a memoised hit priced or read the file")
    with monkeypatch.context() as m:
        m.setattr(autotune, "attn_cost", refuse)
        m.setattr(autotune, "candidate_attn_blocks", refuse)
        m.setattr("builtins.open", refuse)
        for _ in range(3):
            assert autotune.choose_attn_block(p) == first
    autotune._tuning_cache = None                 # a new parse: no memo
    assert autotune.choose_attn_block(p)[1]["cached"] is True


def test_cache_path_follows_the_environment(tmp_path):
    path = str(tmp_path / "elsewhere.json")
    env = dict(os.environ, **{autotune.TUNING_CACHE_ENV: path},
               PYTHONPATH=os.pathsep.join(sys.path))
    out = subprocess.run(
        [sys.executable, "-c", "from repro_torch.core import autotune; "
         "print(autotune.TUNING_CACHE_PATH)"], env=env, check=True,
        capture_output=True, text=True).stdout.strip()
    assert out == path


# ----------------------------------------------------------------------------
# The model's choices
# ----------------------------------------------------------------------------

PROBLEMS = [
    autotune.AttnProblem(sq=256, skv=1280, n_heads=32, head_dim=80),
    autotune.AttnProblem(sq=5, skv=2048, n_heads=32, head_dim=80, batch=8),
    autotune.AttnProblem(sq=5, skv=2048, n_heads=32, head_dim=80, batch=8,
                         in_bytes=4),
    autotune.AttnProblem(sq=1500, skv=1500, n_heads=16, head_dim=64,
                         causal=False, in_bytes=4),
    autotune.AttnProblem(sq=64, skv=64, n_heads=2, head_dim=128),
    autotune.decode_problem(8, 32, 8, 80, 2048, 2, 16),
    autotune.decode_problem(1, 32, 8, 80, 32768, 4, 1),
    autotune.decode_problem(8, 32, 32, 96, 2048, 2, 16),
    autotune.decode_problem(64, 32, 8, 128, 4096, 2, 256),
]


@pytest.mark.parametrize("p", PROBLEMS, ids=lambda p: (
    f"{p.kernel}-sq{p.sq}-skv{p.skv}-b{p.batch}-{p.in_bytes}B"))
def test_choose_attn_block_beats_or_ties_naive(p):
    cfg, terms = autotune.choose_attn_block(p, use_cache=False)
    naive = autotune.naive_attn_block(p)
    assert naive in autotune.candidate_attn_blocks(p)
    t_naive, _ = autotune.attn_cost(p, naive)
    assert terms["time_s"] <= t_naive + 1e-15
    assert cfg in autotune.candidate_attn_blocks(p)
    assert autotune.attn_smem_bytes(p, cfg) <= hwmodel.H100.smem_per_block
    if p.kernel == autotune.PREFILL:
        assert autotune.naive_attn_block(p) == autotune.NAIVE_ATTN_BLOCK \
            == autotune.AttnBlock(64, 64)
    # One shape, one tile: the choice is deterministic.
    assert autotune.choose_attn_block(p, use_cache=False)[0] == cfg


def test_candidates_are_the_instantiated_tiles_that_fit():
    pre = autotune.AttnProblem(sq=256, skv=1280, n_heads=32, head_dim=128)
    assert autotune.candidate_attn_blocks(pre) == [
        autotune.AttnBlock(bq, 64) for bq in _prefill.BLOCK_QS]
    dec = autotune.decode_problem(8, 32, 8, 128, 4096, 2, 256)
    # Splits of 128 and 256 rows both run as one 256-row page.
    assert autotune.candidate_attn_blocks(dec) == [
        autotune.AttnBlock(16, 256), autotune.AttnBlock(16, 512)]
    for p in (pre, dec):
        for c in autotune.candidate_attn_blocks(p):
            assert autotune.attn_smem_bytes(p, c) <= \
                hwmodel.H100.smem_per_block
        tight = autotune.candidate_attn_blocks(p, smem_fraction=0.01)
        assert tight == [autotune.naive_attn_block(p)]


def test_the_model_prices_padding_and_the_cards_fill():
    """The verify's 5 rows: a 16-row block pads 11 rows, a 64-row one 59;
    one CTA of 4 warps fills an SM's schedulers, one of one warp a
    quarter of them."""
    p = autotune.AttnProblem(sq=5, skv=1029, n_heads=32, head_dim=80,
                             batch=8)
    _, t16 = autotune.attn_cost(p, autotune.AttnBlock(16, 64))
    _, t64 = autotune.attn_cost(p, autotune.AttnBlock(64, 64))
    assert t16["tile_rows_used"] == 5 / 16 and t64["tile_rows_used"] == 5 / 64
    assert t16["issued_flops"] * 4 == t64["issued_flops"]
    assert t16["ctas"] == t64["ctas"] == 8 * 32
    assert t64["fill"] == 1.0
    assert t16["fill"] == pytest.approx(8 * 32 / (hwmodel.H100.sms * 4))
    assert autotune.cta_share(p, autotune.AttnBlock(16, 64)) == 0.25


def test_decode_prices_the_split_partials():
    p = autotune.decode_problem(8, 32, 8, 80, 4096, 2, 16)
    terms = {c.block_k: autotune.attn_cost(p, c)[1]
             for c in autotune.candidate_attn_blocks(p)}
    for rows, t in terms.items():
        n_splits = _decode.splits(4096, 16, rows)[1]
        assert t["partial_bytes"] == 2 * 4 * 8 * 32 * n_splits * 82
        assert t["ctas"] == 8 * 8 * 1 * n_splits
    assert terms[128]["partial_bytes"] == 4 * terms[512]["partial_bytes"]


def test_decode_attn_speedup_at_least_one():
    out = autotune.decode_attn_speedup(
        32768, [512, 4096, 16384, 32768], n_heads=32, n_kv_heads=8,
        head_dim=128)
    assert out["speedup"] > 1.0
    for lengths in ([32768, 32768], [1, 1], [100, 32768, 7]):
        assert autotune.decode_attn_speedup(
            32768, lengths, 32, 8, 128)["speedup"] >= 1.0
    full = autotune.decode_attn_speedup(
        32768, [32768, 32768], n_heads=32, n_kv_heads=8, head_dim=128)
    assert full["speedup"] == 1.0


# ----------------------------------------------------------------------------
# The serving models and kernels/cost.py price the chooser's tile
# ----------------------------------------------------------------------------

def _pick(p):
    return autotune.choose_attn_block(p, use_cache=False)[0]


def test_serving_models_price_the_choosers_tile(monkeypatch):
    dims = dict(n_heads=32, n_kv_heads=8, head_dim=80)
    dec = _pick(autotune.decode_problem(8, 32, 8, 80, 2048, 2, 16))
    m = autotune.paged_decode_model(2048, [100, 2048, 700] + [1] * 5,
                                    page_size=16, **dims)
    assert m["tile"] == (dec.block_q, dec.block_k)
    assert m["split_rows"] == _decode.splits(2048, 16, dec.block_k)[0]
    pre = _pick(autotune.AttnProblem(sq=256, skv=4096, n_heads=32,
                                     head_dim=80))
    c = autotune.prefill_chunk_model(4096, 256, page_size=16, **dims)
    assert c["tile"] == (pre.block_q, pre.block_k)
    # The verify tick: the prefill body at sq = k + 1 over the reach.
    ver = _pick(autotune.AttnProblem(sq=5, skv=2064, n_heads=32,
                                     head_dim=80, batch=4))
    launch = autotune.prefill_launch([2047, 10, 500, 1999], 5, 32, 80, 16,
                                     max_rows=2064)
    assert launch["tile"] == (ver.block_q, ver.block_k)
    seen = []
    real = autotune.choose_attn_block

    def spy(p, *a, **kw):
        assert kw.get("use_cache") is False, "the models price uncached"
        out = real(p, *a, **kw)
        seen.append((p.kernel, p.sq, out[0]))
        return out
    monkeypatch.setattr(autotune, "choose_attn_block", spy)
    autotune.spec_decode_model([2048] * 4, page_size=16, k=4,
                               accept_rate=0.7, param_bytes=8e9, **dims)
    assert {(k, sq) for k, sq, _ in seen} == {(autotune.DECODE, 4),
                                              (autotune.PREFILL, 5)}


def test_decode_launch_prices_a_pinned_tile_apart():
    """The tile comes from the cache's shape (the launch's grid), not
    from the live lengths; a pinned tile is priced as given."""
    lengths = [1000] * 8
    picked = autotune.decode_launch(lengths, 32, 8, 80, 16, max_len=2048)
    want = _pick(autotune.decode_problem(8, 32, 8, 80, 2048, 2, 16))
    assert picked["tile"] == (want.block_q, want.block_k)
    for rows in _decode.SPLIT_ROWS_SET:
        pinned = autotune.decode_launch(lengths, 32, 8, 80, 16, max_len=2048,
                                        tile=autotune.AttnBlock(16, rows))
        assert pinned["tile"] == (16, rows)
        assert pinned["page_lookups"] == picked["page_lookups"]
        n_splits = _decode.splits(2048, 16, rows)[1]
        assert pinned["fill"] == autotune.attn_fill(
            autotune.decode_problem(8, 32, 8, 80, 2048, 2, 16),
            autotune.AttnBlock(16, rows), 8 * 8 * n_splits)


def test_the_decode_record_counts_the_chosen_splits():
    """The meta branch (the dry run) records the partials of the splits
    the chosen tile cuts; a pinned tile records its own."""
    q = torch.empty(2, 8, 64, device="meta")
    k = torch.empty(2, 4096, 2, 64, device="meta")
    lens = torch.empty(2, dtype=torch.int32, device="meta")
    chosen = ops.decode_tile(q, 2, 4096)
    for block_k, rows in ((None, chosen.block_k), (128, 128), (512, 512)):
        trace = op_analysis.OpTrace()
        with trace:
            ops.flash_decode(q, k, k, lens, block_k=block_k)
        n_splits = _decode.splits(4096, 1, rows)[1]
        [op] = [o for o in trace.ops if o.kernel]
        assert op.nbytes == cost.flash_decode(2, 8, 2, 64, 4, 2 * 4096,
                                              n_splits=n_splits)[0]
        assert op.flops == cost.flash_decode(2, 8, 2, 64, 4, 2 * 4096)[1]
    assert ops.LAUNCHES["flash_decode"] == 0


def test_autotune_has_the_references_public_names():
    """An AST diff of the two modules' public names: the port lacks only
    ``mxu_efficiency``, whose counterpart (``attn_fill`` and the padded
    rows, ``tile_efficiency`` for the GEMM) its docstring names."""
    import ast

    from repro.core import autotune as jautotune

    def public(mod):
        tree = ast.parse(open(mod.__file__).read())
        out = set()
        for node in tree.body:
            if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
                out.add(node.name)
            elif isinstance(node, ast.Assign):
                out |= {t.id for t in node.targets
                        if isinstance(t, ast.Name)}
        return {n for n in out if not n.startswith("_")}

    assert public(jautotune) - public(autotune) == {"mxu_efficiency"}
    assert "mxu_efficiency" in autotune.__doc__
    assert autotune.NAIVE_BLOCK == autotune.naive_block(2)
