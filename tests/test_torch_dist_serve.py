"""Tensor-parallel paged serving in the PyTorch port over gloo process
groups on the CPU (``serve/dist.py``, ``dist/collective_matmul.py``, the
engine's ``mesh``, the serve launcher's ``--tp``), against the reference.

Every group is started by ``launch.mesh.run_ranks``: spawned ranks, a
free port, a collective timeout and a deadline in this process that
kills every rank and fails. Each rank runs one intra-op thread.

* The page scatter and gather, the cross-rank page copy and the dim
  gather are exact against the one-rank page walk (``paged.gather_kv``);
  ``ag_matmul``/``rs_matmul`` equal ``x @ w`` at rtol 1e-4 (the ring sums
  the contraction in blocks; a non-divisible n or k is the plain
  product, bit for bit) at 2, 4 and 8 ranks.
* The qwen3-4b smoke engine on 2 and 4 ranks (heads, kv heads, mlp and
  vocab split at 2; kv heads replicated at 4) serves greedy, sampled
  (temperature 0.9, seed 5), preempted (a 16-page pool) and speculative
  (``spec_k`` 2, n-gram draft) and prefix-cached (hits and a
  copy-on-write across ranks) streams equal to the reference's
  single-device paged engine's, with a slot whose pages span two ranks,
  one decode (verify) step built, and the reference's pool capacity
  (its ``n_pages`` rounded up to a multiple of the ranks, as the
  reference's mesh engine rounds it).
* Model drafts under the mesh (``"self"`` and an arch name, ``spec_k``
  2) on 2 ranks serve the reference's plain single-device streams, with
  the same drafts proposed and accepted on both ranks; only rank 0
  holds a draft source and proposes (its drafts are broadcast each
  verify tick), rank 1 never does.
* The launcher at ``--tp 2`` serves the reference's launcher streams;
  its refusals; a failing rank fails the run.
"""

import dataclasses
import time

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import transformer as JT
from repro.serve import engine as jengine

from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import serve as launch

import _torch_dist_workers as workers

DEADLINE_S = 90.0
GREEDY = dict(max_len=64, batch=3, eos_id=-1, paged=True, page_size=4,
              chunk_size=8, n_pages=56)
SCENARIOS = [
    ("greedy", GREEDY, 3, 12, None),
    ("sampled", dict(GREEDY, temperature=0.9, seed=5), 3, 8, None),
    ("preempt", dict(max_len=64, batch=4, eos_id=-1, paged=True,
                     page_size=4, chunk_size=8, n_pages=16), 4, 10, None),
    ("spec", dict(max_len=64, batch=3, eos_id=-1, paged=True, page_size=4,
                  chunk_size=8, spec_k=2, draft="ngram"), 3, 10, None),
    ("prefix", dict(max_len=64, batch=1, eos_id=-1, paged=True, page_size=4,
                    chunk_size=8, n_pages=16, prefix_cache=True), 3, 6,
     workers.shared_prompts(128)),
]


@pytest.fixture(scope="module")
def reference():
    """The reference's params (numpy) and its single-device engine's
    streams and counters for each scenario."""
    jcfg = jconfigs.get_smoke("qwen3-4b")
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
    out = {}
    for name, kw, n_req, max_new, prompts in SCENARIOS:
        prompts = prompts or workers._prompts(jcfg.vocab)
        eng = jengine.ServingEngine(jparams, jcfg, jengine.ServeConfig(**kw))
        for i, p in enumerate(prompts[:n_req]):
            eng.submit(jengine.Request(rid=i, prompt=p.copy(),
                                       max_new=max_new))
        out[name] = {"streams": {k: list(v) for k, v in
                                 eng.run_until_drained().items()},
                     "preemptions": eng.preemptions,
                     "prefix_hits": eng.prefix_hits,
                     "cow_copies": eng.cow_copies,
                     "capacity": eng.pool.capacity}
    return jax.tree.map(np.asarray, jparams), out


@pytest.mark.parametrize("world", [2, 4, 8])
def test_page_walk_copy_and_rings_are_exact(world):
    t0 = time.monotonic()
    done = mesh_lib.run_ranks(workers.primitives, world,
                              deadline_s=DEADLINE_S)
    assert all(d == done[0] for d in done)
    assert done[0] == ["gather", "scatter", "copy_page", "all_gather_dim",
                       "rings", "serve_unembed"]
    assert time.monotonic() - t0 < DEADLINE_S


@pytest.mark.parametrize("world", [2, 4])
def test_engine_streams_equal_the_reference_single_device(reference, world):
    np_params, want = reference
    ranks = mesh_lib.run_ranks(workers.serve_scenarios, world,
                               args=(np_params, SCENARIOS),
                               deadline_s=DEADLINE_S)
    for name, _, _, _, _ in SCENARIOS:
        got = ranks[0][name]
        assert all(r[name]["streams"] == got["streams"] for r in ranks)
        assert got["streams"] == want[name]["streams"], name
        assert got["n_devices"] == world
        # The same pool (the reference's n_pages rounded up to a multiple
        # of the ranks, as its mesh engine rounds it): one global null
        # page, the rest in equal blocks.
        n_pages = want[name]["capacity"] + 1
        assert got["capacity"] + 1 == -(-n_pages // world) * world
        assert got["local_pages"] * world == got["capacity"] + 1
    assert any(len(v) >= 2 for v in ranks[0]["greedy"]["spans"].values())
    assert ranks[0]["greedy"]["decode_traces"] == 1
    assert ranks[0]["spec"]["verify_traces"] == 1
    assert ranks[0]["preempt"]["preemptions"] == \
        want["preempt"]["preemptions"] > 0
    # Prefix hits map pages across ranks; the copy-on-write of a shared
    # page crosses ranks through ``serve.dist.copy_page``.
    for key in ("prefix_hits", "cow_copies"):
        assert ranks[0]["prefix"][key] == want["prefix"][key] > 0, key


DRAFTS = [("self", "self"), ("arch", "qwen2-0.5b")]


def test_model_drafts_under_a_mesh_serve_the_plain_streams(reference):
    """Speculative engines with a model draft on two ranks: the greedy
    streams of the reference's plain engine, on both ranks, and equal
    draft counters on both ranks; rank 0 alone holds a draft source and
    proposes, and rank 1 verifies the drafts it broadcasts."""
    import _torch_model_axis_workers as axis_workers

    np_params, want = reference
    name, kw, n_req, max_new, _ = SCENARIOS[0]
    prompts = workers._prompts(128)[:n_req]
    runs = [(label, "qwen3-4b", {}, np_params,
             dict(kw, spec_k=2, draft=draft), prompts, max_new)
            for label, draft in DRAFTS]
    ranks = mesh_lib.run_ranks(axis_workers.serve_streams, 2,
                               args=(runs,), deadline_s=DEADLINE_S)
    for label, _ in DRAFTS:
        got = [r[label] for r in ranks]
        for r in got:
            assert r["streams"] == want[name]["streams"], label
            assert (r["proposed"], r["accepted"], r["verify_steps"]) == (
                got[0]["proposed"], got[0]["accepted"],
                got[0]["verify_steps"]), label
        assert got[0]["proposed"] > 0 and got[0]["verify_steps"] > 0
        assert got[0]["draft_calls"] > 0 and got[1]["draft_calls"] is None
    assert ranks[0]["self"]["accepted"] > 0


def test_a_two_by_two_mesh_has_a_group_a_line():
    got = mesh_lib.run_ranks(workers.mesh_lines, 4, deadline_s=DEADLINE_S)
    assert [c for c, _ in got] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    # rank = 2 * data + model: a "model" line sums 2d + 0 + 2d + 1, a
    # "data" line m + (2 + m).
    assert [s for _, s in got] == [
        {"data": 2.0, "model": 1.0}, {"data": 4.0, "model": 1.0},
        {"data": 2.0, "model": 5.0}, {"data": 4.0, "model": 5.0}]


def test_a_failing_rank_fails_the_run_before_the_deadline():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="planted failure on rank 1"):
        mesh_lib.run_ranks(workers.fail_on_rank_one, 2, deadline_s=60.0,
                           timeout_s=60.0)
    assert time.monotonic() - t0 < 30.0


def test_bandwidth_curve_runs_over_gloo():
    rows = mesh_lib.run_ranks(workers.bandwidth, 2, deadline_s=DEADLINE_S)
    assert [r[:3] for r in rows[0]] == [
        ("all_reduce", 4096, 4096.0), ("all_reduce", 65536, 65536.0),
        ("broadcast", 4096, 4096.0), ("broadcast", 65536, 65536.0)]
    assert all(r[3] > 0 for r in rows[0])


ARGS = ["--arch", "qwen3-4b", "--smoke", "--device", "cpu", "--paged",
        "--max-len", "64", "--page-size", "8", "--chunk-size", "8",
        "--max-new", "6", "--requests", "4"]


def test_launcher_serves_tp2_as_one_rank(capfd):
    one = launch.main(ARGS)
    capfd.readouterr()
    two = launch.main(ARGS + ["--tp", "2"])
    out = capfd.readouterr().out          # the ranks' own stdout
    assert two == one
    assert "tensor-parallel over model=2" in out
    assert "pool sharded by pages over 2 ranks" in out
    assert out.count("served 4 requests") == 1      # rank 0 reports
    assert launch.main(ARGS + ["--mesh", "model=2"]) == one


@pytest.mark.parametrize("flags,match", [
    (["--tp", "2", "--mesh", "model=2"], "two spellings"),
    (["--mesh", "data=2"], "model=N"),
])
def test_launcher_refusals(flags, match):
    with pytest.raises(SystemExit, match=match):
        launch.main(ARGS + flags)


@pytest.mark.parametrize("flag", [["--tp", "2"], ["--mesh", "model=2"]])
def test_launcher_tp_needs_paged(flag):
    args = [a for a in ARGS if a != "--paged"]
    with pytest.raises(SystemExit, match="need --paged"):
        launch.main(args + flag)


def test_launcher_fails_when_its_ranks_fail():
    """Every rank raises at engine construction (a page size that does not
    divide max_len): the launcher raises instead of serving on one."""
    args = ARGS[:]
    args[args.index("--page-size") + 1] = "7"
    args[args.index("--chunk-size") + 1] = "7"
    with pytest.raises(RuntimeError, match="rank .* failed"):
        launch.main(args + ["--tp", "2"])


def test_capture_under_a_mesh_is_refused_on_the_card(monkeypatch):
    """A gloo group's collectives cannot be captured: the engine refuses
    ``capture=True`` on a card under a mesh, and never drops to eager on
    its own. (Checked on the refusal itself, which runs before any
    tensor is made.) A mixture of experts and a model draft pass the
    check (``tests/test_torch_expert_parallel.py`` and the draft cases
    below serve them)."""
    from repro_torch import configs
    from repro_torch.serve.engine import ServeConfig, ServingEngine

    cfg = configs.get_smoke("qwen3-4b")

    class Mesh:
        shape = {"model": 2}

    eng = ServingEngine.__new__(ServingEngine)
    eng.device = torch.device("cuda")
    with pytest.raises(ValueError, match="cannot be captured"):
        eng._check_mesh(cfg, ServeConfig(max_len=64, batch=2, paged=True),
                        capture=True)
    with pytest.raises(ValueError, match="paged-only"):
        eng._check_mesh(cfg, ServeConfig(max_len=64, batch=2), capture=False)
    assert eng._check_mesh(configs.get_smoke("dbrx-132b"),
                           ServeConfig(max_len=64, batch=2, paged=True),
                           capture=False) is None
    assert eng._check_mesh(cfg, ServeConfig(max_len=64, batch=2, paged=True,
                                            spec_k=2, draft="self"),
                           capture=False) is None
