"""Expert parallelism in the PyTorch port (``models/moe.py`` over a model
axis) against the reference on one device.

Ranks are gloo CPU processes started by ``launch.mesh.run_ranks`` with
one intra-op thread each (rank functions in
``tests/_torch_model_axis_workers.py``, no JAX); one group of 2 ranks and
one of 4 run every case of their size. The reference runs here under
``JAX_PLATFORMS=cpu`` and its parameters cross as numpy (through
``bridge.params_from_jax`` for whole models).

* ``moe_apply`` of the dbrx-132b smoke mixture (4 experts, top-2) and
  the llama4-maverick smoke one (8 experts, top-1, a shared expert), by
  ``capacity`` at factor 0.5 (so choices are dropped) and by
  ``dense_mask``, inside a train step's mesh at (data 1, model 2), (1, 4)
  and (2, 2), and under a serving mesh of 2 and 4 ranks, against the
  reference's ``moe_apply`` over the whole batch: output and aux loss
  within 1e-5 absolute plus 1e-5 relative (``tests/test_torch_moe.py``'s
  tolerance: only the order of fp32 sums differs), and the drops equal to
  the reference routing's. The experts split over the ranks; 6 experts
  at model 4 do not divide it, so the rules split each expert's ``mlp``
  dim instead and every rank routes with the whole router.
* A train step's loss and gradients, the router's above all, at
  ``aux_weight`` 1.0 (the aux loss's gradient then rivals the nll's) over
  (1, 2) and (2, 2), against ``jax.value_and_grad`` of the reference's
  ``loss_fn``: loss within 1e-6 relative, every leaf's gradient within
  1e-5 of its largest element. The aux loss's gradient counted once a
  rank (a planted fault) must break the router's.
* The paged engine on 2 and 4 ranks serves the dbrx smoke (by capacity)
  and llama4 smoke (by dense mask) greedy streams of the reference's
  single-device engine.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import configs as jconfigs
from repro.models import moe as jmoe
from repro.models import transformer as JT
from repro.serve import engine as jengine
from repro.train import steps as jsteps

from repro_torch.bridge import params_from_jax
from repro_torch.launch import mesh as mesh_lib
from repro_torch.tree import tree_items

import _torch_model_axis_workers as workers

DEADLINE_S = 120.0
ATOL = RTOL = 1e-5
LOSS_RTOL = 1e-6
GRAD_TOL = 1e-5
B, S = 4, 6
MIXTURES = {   # name -> MoEConfig fields of the smoke configs' mixtures
    "dbrx": dict(d_model=32, d_ff=64, n_experts=4, top_k=2),
    "llama4": dict(d_model=32, d_ff=64, n_experts=8, top_k=1, n_shared=1),
    "six_experts": dict(d_model=32, d_ff=64, n_experts=6, top_k=2),
}
IMPLS = {"capacity": dict(impl="capacity", capacity_factor=0.5),
         "dense_mask": dict(impl="dense_mask")}
MESHES = {"train_1x2": ("train", (1, 2)), "train_1x4": ("train", (1, 4)),
          "train_2x2": ("train", (2, 2)), "serve_2": ("serve", (1, 2)),
          "serve_4": ("serve", (1, 4))}
MOE_CASES = [(m, i, k) for m in ("dbrx", "llama4") for i in IMPLS
             for k in MESHES] + [
    ("six_experts", i, k) for i in IMPLS for k in ("train_1x4", "serve_4")]
CAPACITY = dict(moe_impl="capacity", moe_capacity_factor=0.5)
# name -> (arch, config fields, mesh shape, planted fault)
GRAD_CASES = {
    "dbrx_capacity_1x2": ("dbrx-132b", CAPACITY, (1, 2), None),
    "dbrx_capacity_2x2": ("dbrx-132b", CAPACITY, (2, 2), None),
    "llama4_1x2": ("llama4-maverick-400b-a17b", {}, (1, 2), None),
    "dbrx_capacity_1x2_aux_once_a_rank": ("dbrx-132b", CAPACITY, (1, 2),
                                          "aux_once_a_rank"),
}
AUX_WEIGHT = 1.0
SERVE = dict(max_len=64, batch=3, eos_id=-1, paged=True, page_size=4,
             chunk_size=8)
# name -> (arch, config fields)
ENGINES = {"dbrx_capacity": ("dbrx-132b", dict(moe_impl="capacity")),
           "llama4": ("llama4-maverick-400b-a17b", {})}
PROMPT_LENS, MAX_NEW = (9, 13, 6), 8


@functools.lru_cache(maxsize=None)
def _moe_reference(mixture, impl):
    """The reference's numpy parameters, input, output, aux and drops of
    one mixture (seeded by its name)."""
    seed = sorted(MIXTURES).index(mixture)
    kw = dict(MIXTURES[mixture], **IMPLS[impl])
    jcfg = jmoe.MoEConfig(**kw)
    jp = jax.tree.map(np.asarray, jmoe.moe_init(jax.random.PRNGKey(seed),
                                                jcfg))
    x = np.random.RandomState(seed + 1).randn(B, S, kw["d_model"]).astype(
        np.float32)


    def run(p, x):
        out, aux = jmoe.moe_apply(p, jcfg, x)
        return out, aux, jmoe._route(p, jcfg, x.reshape(B * S, -1))[1]

    want, want_aux, ids = jax.jit(run)(jp, jnp.asarray(x))
    counts = np.bincount(np.asarray(ids).reshape(-1),
                         minlength=jcfg.n_experts)
    cap = max(int(np.ceil(B * S * jcfg.top_k / jcfg.n_experts
                          * jcfg.capacity_factor)), 4)
    return kw, jp, x, dict(out=np.asarray(want), aux=float(want_aux),
                           drops=int(np.maximum(counts - cap, 0).sum()))


def _moe_case(mixture, impl, mesh):
    kw, jp, x, want = _moe_reference(mixture, impl)
    mode, shape = MESHES[mesh]
    return dict(mode=mode, shape=shape, cfg=kw, params=jp, x=x), want


def _batch(cfg, seed=0):
    rng = np.random.RandomState(seed)
    return {"tokens": rng.randint(0, cfg.vocab, (B, 16)).astype(np.int32),
            "labels": rng.randint(0, cfg.vocab, (B, 16)).astype(np.int32)}


@functools.lru_cache(maxsize=None)
def _grad_reference(arch, fields):
    """The reference's numpy parameters, batch, loss, aux and gradients
    (flat, as the port's tree) at AUX_WEIGHT."""
    jcfg = dataclasses.replace(jconfigs.get_smoke(arch), **dict(fields))
    jparams = jsteps.init_state(jax.random.PRNGKey(0), jcfg).tree()["params"]
    batch = _batch(jcfg)
    (loss, parts), grads = jax.jit(jax.value_and_grad(
        lambda p, b: jsteps.loss_fn(p, jcfg, b, aux_weight=AUX_WEIGHT),
        has_aux=True))(jparams, {k: jnp.asarray(v) for k, v in
                                 batch.items()})
    cfg = workers.port_cfg(dict(arch=arch, fields=dict(fields)))
    flat = {k: v.numpy() for k, v in tree_items(params_from_jax(
        jax.tree.map(np.asarray, grads), cfg, device="cpu"))}
    return (jax.tree.map(np.asarray, jparams), batch,
            dict(loss=float(loss), aux=float(parts["aux"]), grads=flat))


def _reference_streams(arch, fields):
    jcfg = dataclasses.replace(jconfigs.get_smoke(arch), **fields)
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
    eng = jengine.ServingEngine(jparams, jcfg, jengine.ServeConfig(**SERVE))
    prompts = _prompts(jcfg.vocab)
    for i, p in enumerate(prompts):
        eng.submit(jengine.Request(rid=i, prompt=p.copy(), max_new=MAX_NEW))
    streams = {k: list(v) for k, v in eng.run_until_drained().items()}
    return jax.tree.map(np.asarray, jparams), prompts, streams


def _prompts(vocab):
    rng = np.random.RandomState(7)
    return [rng.randint(2, vocab, n).astype(np.int32) for n in PROMPT_LENS]


@pytest.fixture(scope="module")
def runs():
    """Every case's reference and the ranks' results: one group of 2
    ranks and one of 4."""
    moe_ref, moe_in = {}, {}
    for key in MOE_CASES:
        moe_in[key], moe_ref[key] = _moe_case(*key)
    grad_in = {}
    for name, (arch, fields, shape, plant) in GRAD_CASES.items():
        params, batch, _ = _grad_reference(arch, tuple(sorted(
            fields.items())))
        grad_in[name] = dict(kind="grad", arch=arch, fields=fields,
                             shape=shape, plant=plant, params=params,
                             batch=batch, aux_weight=AUX_WEIGHT)
    engines = {}
    for name, (arch, fields) in ENGINES.items():
        engines[name] = _reference_streams(arch, fields)
    got_moe, got_grads, got_streams = {}, {}, {}
    for world in (2, 4):
        moe_keys = [k for k in MOE_CASES if moe_in[k]["shape"][0]
                    * moe_in[k]["shape"][1] == world]
        grad_keys = [k for k, c in grad_in.items()
                     if c["shape"][0] * c["shape"][1] == world]
        serve = [(name, ENGINES[name][0], ENGINES[name][1], p, SERVE,
                  prompts, MAX_NEW)
                 for name, (p, prompts, _) in engines.items()]
        ranks = mesh_lib.run_ranks(
            workers.expert_parallel_group, world, args=([moe_in[k] for k in moe_keys],
                                 [grad_in[k] for k in grad_keys], serve),
            deadline_s=DEADLINE_S)
        for i, k in enumerate(moe_keys):
            got_moe[k] = [r["moe"][i] for r in ranks]
        for i, k in enumerate(grad_keys):
            got_grads[k] = [r["grads"][i] for r in ranks]
        for name in engines:
            got_streams[(name, world)] = [r["serve"][name] for r in ranks]
    return dict(moe=(moe_ref, got_moe), grads=got_grads,
                streams=({k: v[2] for k, v in engines.items()},
                         got_streams))


@pytest.mark.parametrize("key", MOE_CASES, ids="-".join)
def test_moe_apply_over_a_model_axis_matches_the_reference(runs, key):
    want, got = runs["moe"][0][key], runs["moe"][1][key]
    mixture, impl, _ = key
    for r in got:
        np.testing.assert_allclose(r["out"], want["out"], atol=ATOL,
                                   rtol=RTOL)
        assert r["aux"] == pytest.approx(want["aux"], abs=ATOL, rel=RTOL)
        assert r["drops"] == want["drops"]
        if mixture == "six_experts":
            # The divisibility fallback: the experts' mlp dim is split.
            assert r["specs"] == {"router": [None, None],
                                  "expert_gate": [None, None, "model"]}
        else:
            assert r["specs"] == {"router": [None, "model"],
                                  "expert_gate": ["model", None, None]}
    if impl == "capacity":
        assert want["drops"] > 0


@pytest.mark.parametrize("name", [n for n, c in GRAD_CASES.items()
                                  if c[3] is None])
def test_train_step_over_a_model_axis_matches_the_reference(runs, name):
    """Loss, aux and every gradient at aux_weight 1.0, the router's
    included, on every rank; the experts and the router split."""
    arch, fields, _, _ = GRAD_CASES[name]
    want = _grad_reference(arch, tuple(sorted(fields.items())))[2]
    for r in runs["grads"][name]:
        assert r["loss"] == pytest.approx(want["loss"], rel=LOSS_RTOL)
        assert r["aux"] == pytest.approx(want["aux"], rel=LOSS_RTOL)
        assert r["grads"].keys() == want["grads"].keys()
        for key, w in want["grads"].items():
            scale = float(np.abs(w).max())
            err = float(np.abs(r["grads"][key] - w).max())
            assert err <= GRAD_TOL * scale, (key, err, scale)
        moe_keys = [k for k in r["specs"] if "/moe/" in k]
        assert moe_keys and all(
            "model" in r["specs"][k] for k in moe_keys
            if "/shared/" not in k)


def test_aux_loss_counted_once_a_rank_breaks_the_router_gradient(runs):
    arch, fields, _, _ = GRAD_CASES["dbrx_capacity_1x2_aux_once_a_rank"]
    want = _grad_reference(arch, tuple(sorted(fields.items())))[2]
    for r in runs["grads"]["dbrx_capacity_1x2_aux_once_a_rank"]:
        errs = [float(np.abs(r["grads"][k] - w).max())
                / float(np.abs(w).max())
                for k, w in want["grads"].items() if k.endswith("router")]
        assert errs and max(errs) > 100 * GRAD_TOL, errs


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", list(ENGINES))
def test_engine_streams_over_experts_split_equal_the_reference(runs, name,
                                                                world):
    want, got = runs["streams"][0][name], runs["streams"][1][(name, world)]
    for r in got:
        assert r["streams"] == want


def test_serve_launcher_serves_a_mixture_at_tp2_as_one_rank(capfd):
    """``launch/serve.py --tp 2`` serves the dbrx smoke, its experts
    split over the two ranks, with one rank's streams."""
    from repro_torch.launch import serve as launch

    args = ["--arch", "dbrx-132b", "--smoke", "--device", "cpu", "--paged",
            "--max-len", "64", "--page-size", "8", "--chunk-size", "8",
            "--max-new", "6", "--requests", "4"]
    one = launch.main(args)
    two = launch.main(args + ["--tp", "2"])
    assert two == one and len(one) == 4
    assert "tensor-parallel over model=2" in capfd.readouterr().out
