"""Rank functions for ``tests/test_torch_expert_parallel.py`` and
``tests/test_torch_model_axis_families.py``: each runs in a process that
``repro_torch.launch.mesh.run_ranks`` spawned and joined to a gloo group,
and returns plain Python values (numpy arrays, numbers, lists). This
module imports neither JAX nor the reference."""

import dataclasses
import functools
import os

import numpy as np
import torch

from repro_torch import configs
from repro_torch.bridge import params_from_jax
from repro_torch.checkpoint import CheckpointManager
from repro_torch.dist import sharding
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import moe
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.serve import dist as serve_dist
from repro_torch.serve.engine import Request, ServeConfig, ServingEngine
from repro_torch.train import dist as train_dist
from repro_torch.train import steps
from repro_torch.tree import tree_items, tree_map

AXES = {2: ("data", "model"), 3: ("pod", "data", "model")}


def _np_tree(tree):
    return {k: v.detach().numpy().copy() for k, v in tree_items(tree)}


def _torch_tree(np_tree):
    return {k: _torch_tree(v) if isinstance(v, dict)
            else torch.from_numpy(np.array(v)) for k, v in np_tree.items()}


# ----------------------------------------------------------------------------
# moe_apply over a model axis
# ----------------------------------------------------------------------------

def _moe_train(case, params, cfg, x):
    """``moe_apply`` and ``dropped`` inside a train step's mesh of
    ``case["shape"]`` over (data, model): this rank's rows of x, its
    shards of the parameters; the output gathered over the data ranks."""
    mesh = mesh_lib.make_mesh(case["shape"], AXES[2])
    ruleset = sharding.Ruleset(mesh=mesh)
    local = sharding.shard_tree(params, mesh, ruleset)
    rows, axes = train_dist.batch_block({"x": x}, ruleset)
    tm = train_dist.TrainMesh(ruleset, axes)
    with torch.no_grad(), train_dist.use_mesh(tm):
        out, aux = moe.moe_apply(local, cfg, rows["x"])
        drops = moe.dropped(local, cfg, rows["x"])
    out = tm.stack(out, axes).reshape(x.shape) if axes else out
    return out, aux, drops, _expert_spec(params, ruleset)


def _moe_serve(case, params, cfg, x):
    """``moe_apply`` and ``dropped`` under a serving mesh of every rank
    (``serve.dist``: the engine's ruleset), this rank's shards."""
    mesh = mesh_lib.make_serving_mesh(case["shape"][-1])
    rules = serve_dist.serve_ruleset(mesh)
    local = serve_dist.shard_params(params, mesh, rules)
    with torch.no_grad(), sharding.use_ruleset(rules):
        out, aux = moe.moe_apply(local, cfg, x)
        drops = moe.dropped(local, cfg, x)
    return out, aux, drops, _expert_spec(params, rules)


def _expert_spec(params, ruleset):
    """The specs the rules give the router and an expert leaf."""
    return {k: list(sharding.param_spec((k,), tuple(params[k].shape),
                                        ruleset))
            for k in ("router", "expert_gate")}


def moe_cases(rank, world, cases):
    """Each case (``mode`` "train" or "serve", ``shape``, ``cfg`` the
    ``MoEConfig`` fields, ``params`` numpy, ``x`` (b, s, d)): the whole
    output, the aux loss, the drops and the specs of the router and the
    expert leaves."""
    out = []
    for case in cases:
        cfg = moe.MoEConfig(**case["cfg"])
        params = _torch_tree(case["params"])
        x = torch.from_numpy(case["x"])
        run = _moe_train if case["mode"] == "train" else _moe_serve
        got, aux, drops, specs = run(case, params, cfg, x)
        out.append({"out": got.numpy(), "aux": float(aux),
                    "drops": int(drops), "specs": specs})
    return out


# ----------------------------------------------------------------------------
# Train steps over a model axis
# ----------------------------------------------------------------------------

def port_cfg(case):
    return dataclasses.replace(configs.get_smoke(case["arch"]),
                               **case.get("fields", {}))


_REAL = {"once": moe._ModelSplit.once,
         "all_sum": train_dist.TrainMesh.all_sum,
         "loss_fn": steps.loss_fn}


def _plant(plant=None, aux_weight=None):
    """Install the case's loss weight and planted fault; with neither,
    put the real functions back."""
    moe._ModelSplit.once = _REAL["once"]
    train_dist.TrainMesh.all_sum = _REAL["all_sum"]
    steps.loss_fn = _REAL["loss_fn"] if aux_weight is None else \
        functools.partial(_REAL["loss_fn"], aux_weight=aux_weight)
    if plant == "aux_once_a_rank":
        # The aux loss's gradient counted once a rank.
        moe._ModelSplit.once = lambda self, x: x
    elif plant == "norm_local":
        # The Mamba norm's sum of squares over this rank's heads only.
        train_dist.TrainMesh.all_sum = lambda self, x, axis: x


def _batch(case):
    return {k: torch.from_numpy(v) for k, v in case["batch"].items()}


def grad_case(case):
    """One case on this rank: the reference's parameters (``params``,
    numpy, as ``jax`` holds them) sharded over ``shape``; the loss, aux
    and averaged gradients of ``batch`` (gathered whole), at
    ``aux_weight`` with ``plant`` installed; with ``step``, one train
    step too (``compress`` int8) and its parameters gathered whole."""
    cfg = port_cfg(case)
    mesh = mesh_lib.make_mesh(case["shape"], AXES[len(case["shape"])])
    ruleset = sharding.Ruleset(mesh=mesh)
    full = params_from_jax(case["params"], cfg, device="cpu",
                           dtype=torch.float32)
    params = sharding.shard_tree(full, mesh, ruleset)
    specs = sharding.leaf_specs(T.param_shapes(cfg), ruleset)
    _plant(case.get("plant"), case.get("aux_weight"))
    try:
        loss, parts, grads, tm = steps.make_grad_fn(cfg, 1, ruleset)(
            params, _batch(case))
        out = {"loss": float(loss), "aux": float(parts["aux"]),
               "grads": _np_tree(sharding.gather_tree(grads, specs, mesh)),
               "traffic": dict(tm.traffic),
               "specs": {k: list(v) for k, v in specs.items()
                         if any(a is not None for a in v)}}
        if case.get("step"):
            state = steps.TrainState(
                params=params, opt=adamw.adamw_init(params),
                step=torch.zeros((), dtype=torch.int32)).tree()
            step = steps.make_train_step(
                cfg, compress_grads=case.get("compress", False),
                ruleset=ruleset)
            state, m = step(state, _batch(case))
            out["metrics"] = {k: float(v) for k, v in m.items()}
            out["params"] = _np_tree(sharding.gather_tree(
                state["params"], specs, mesh))
    finally:
        _plant()
    return out


def encode_case(case):
    """whisper smoke's ``encode`` under a train step's mesh: the output
    (b, n, d), and the gradient of ``sum(encode * weights)`` (weights
    numpy, the output's shape) for every encoder leaf, gathered whole.
    The frontend is the global batch's; this rank encodes its rows."""
    cfg = port_cfg(case)
    mesh = mesh_lib.make_mesh(case["shape"], AXES[2])
    ruleset = sharding.Ruleset(mesh=mesh)
    full = params_from_jax(case["params"], cfg, device="cpu",
                           dtype=torch.float32)
    params = sharding.shard_tree(full, mesh, ruleset)
    specs = sharding.leaf_specs(T.param_shapes(cfg), ruleset)
    rows, axes = train_dist.batch_block(
        {"f": torch.from_numpy(case["frontend"]),
         "w": torch.from_numpy(case["weights"])}, ruleset)
    tm = train_dist.TrainMesh(ruleset, axes)
    tracked = tree_map(lambda p: p.detach().requires_grad_(), params)
    with torch.enable_grad(), train_dist.use_mesh(tm):
        y = T.encode(tracked, cfg, rows["f"])
        leaves = [(k, v) for k, v in tree_items(tracked)
                  if k.startswith("encoder/")]
        g = torch.autograd.grad((y * rows["w"]).sum(),
                                [v for _, v in leaves])
    whole = {}
    for (k, _), gk in zip(leaves, g):
        gk = tm.all_reduce(gk.contiguous().clone(), tuple(
            a for a in axes if a not in sharding.spec_axes(specs[k])))
        whole[k] = sharding.gather_leaf(gk, specs[k], mesh).numpy()
    y = tm.stack(y.detach(), axes).reshape(case["frontend"].shape) \
        if axes else y.detach()
    return {"encode": y.numpy(), "grads": whole}


def model_axis_cases(rank, world, cases):
    """Every case whose mesh has ``world`` ranks, in order."""
    return [encode_case(c) if c["kind"] == "encode" else grad_case(c)
            for c in cases]


def checkpoint_round_trip(rank, world, arch, directory):
    """A state of ``arch``'s smoke config from seed 3 sharded over (1,
    world), saved as step 1 under its ruleset into ``directory/arch``,
    then restored at (1, world) again: whether every restored shard
    equals the saved one, and the leaves the model axis shards."""
    cfg = configs.get_smoke(arch)
    mesh = mesh_lib.make_mesh((1, world), AXES[2])
    ruleset = sharding.Ruleset(mesh=mesh)
    state = steps.init_state(cfg, 3, "cpu", ruleset=ruleset).tree()
    mgr = CheckpointManager(os.path.join(directory, arch))
    mgr.save(1, state, ruleset=ruleset, shapes=steps.state_shapes(cfg))
    like = tree_map(torch.zeros_like, state)
    got, manifest = mgr.restore(like, ruleset=ruleset)
    same = all(torch.equal(a, b) for (_, a), (_, b) in
               zip(tree_items(got), tree_items(state)))
    sharded = sorted(k for k, v in sharding.leaf_specs(
        steps.state_shapes(cfg), ruleset).items()
        if "model" in sharding.spec_axes(v))
    return {"same": same, "step": manifest["step"], "sharded": sharded}


# ----------------------------------------------------------------------------
# Serving over a model axis
# ----------------------------------------------------------------------------

def serve_streams(rank, world, runs):
    """Smoke engines on a ``world``-rank serving mesh, each run ``(name,
    arch, config fields, numpy params, ServeConfig fields, prompts,
    max_new)``: streams, spec counters, and the calls this rank made to
    its draft source's ``propose`` (``draft_calls``; None where it holds
    no draft source)."""
    mesh = mesh_lib.make_serving_mesh(world)
    out = {}
    for name, arch, fields, np_params, kw, prompts, max_new in runs:
        cfg = dataclasses.replace(configs.get_smoke(arch), **fields)
        params = params_from_jax(np_params, cfg, device="cpu")
        eng = ServingEngine(params, cfg, ServeConfig(**kw), device="cpu",
                            mesh=mesh)
        calls = []
        if eng.draft is not None:
            real = eng.draft.propose
            eng.draft.propose = lambda h, k: calls.append(1) or real(h, k)
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=np.asarray(p, np.int32),
                               max_new=max_new))
        eng.run_until_drained()
        out[name] = {"streams": {k: list(v) for k, v in
                                 eng.finished.items()},
                     "proposed": eng.spec_proposed,
                     "accepted": eng.spec_accepted,
                     "verify_steps": eng.verify_steps,
                     "draft_calls": None if eng.draft is None
                     else len(calls)}
    return out


def expert_parallel_group(rank, world, moe_cases_, grad_cases, serve):
    """Every case of ``tests/test_torch_expert_parallel.py`` whose mesh
    has ``world`` ranks."""
    return {"moe": moe_cases(rank, world, moe_cases_),
            "grads": model_axis_cases(rank, world, grad_cases),
            "serve": serve_streams(rank, world, serve)}


def model_axis_group(rank, world, cases, checkpointed, directory):
    """Every case of ``tests/test_torch_model_axis_families.py`` whose
    mesh has ``world`` ranks, and the checkpoint round trip of each of
    ``checkpointed``."""
    return {"cases": model_axis_cases(rank, world, cases),
            "checkpoints": {arch: checkpoint_round_trip(rank, world, arch,
                                                        directory)
                            for arch in checkpointed}}
