"""Rank functions for ``tests/test_torch_train_dist.py``,
``tests/test_torch_pipeline.py`` and ``tests/test_torch_elastic.py``:
each runs in a process that ``repro_torch.launch.mesh.run_ranks`` spawned
and joined to a gloo group (one intra-op thread), and returns plain
Python values and numpy arrays. This module imports neither JAX nor the
reference, so a spawned rank starts quickly."""

import dataclasses
import os
import shutil
import types

import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.bridge import params_from_jax
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import DataConfig, SyntheticLMData
from repro_torch.dist import compression, pipeline, sharding
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import train as launch
from repro_torch.models import moe
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.train import steps
from repro_torch.train.trainer import Trainer, TrainerConfig
from repro_torch.tree import tree_items

AXES = {2: ("data", "model"), 3: ("pod", "data", "model")}
# FSDP shards leaves of at least this many elements in these tests (the
# rules' 65,536 would leave every smoke leaf whole).
FSDP_MIN_ELEMENTS = 256


def port_cfg(case):
    cfg = configs.get_smoke(case["arch"])
    return dataclasses.replace(cfg, **case.get("fields", {}))


def to_torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def whole(tree, cfg, ruleset):
    """{path: numpy} of a tree of parameter shards gathered whole."""
    specs = sharding.leaf_specs(T.param_shapes(cfg), ruleset)
    full = sharding.gather_tree(tree, specs, ruleset.mesh)
    return {k: v.numpy().copy() for k, v in tree_items(full)}


def recording_drops(records):
    """``moe.moe_apply`` wrapped to append each call's dropped choices
    (the whole batch's, under the active mesh) to ``records``."""
    orig = moe.moe_apply

    def wrapped(params, cfg, x):
        records.append(int(moe.dropped(params, cfg, x.detach())))
        return orig(params, cfg, x)

    return orig, wrapped


def train_case(case):
    """One case of ``test_torch_train_dist.py`` on this rank: the
    reference's parameters sharded over ``case["shape"]``, the first
    batch's averaged gradients gathered whole, then ``len(batches)``
    steps; returns the losses and aux, the gradients, the parameters
    after the steps (whole) and the drops of every mixture call of the
    first gradient."""
    cfg = port_cfg(case)
    shape = case["shape"]
    mesh = mesh_lib.make_mesh(shape, AXES[len(shape)])
    ruleset = sharding.Ruleset(mesh=mesh, fsdp=case.get("fsdp", False))
    ef = case.get("ef", False)
    full = params_from_jax(case["np_params"], cfg, device="cpu",
                           dtype=torch.float32)
    state = steps.TrainState(
        params=full, opt=adamw.adamw_init(full),
        step=torch.zeros((), dtype=torch.int32),
        ef=compression.ErrorFeedback.init(full) if ef else None).tree()
    state = sharding.shard_tree(state, mesh, ruleset)
    accum = case.get("accum", 1)
    batches = [to_torch_batch(b) for b in case["batches"]]
    drops = []
    orig, moe.moe_apply = recording_drops(drops)
    try:
        _, _, grads, tm = steps.make_grad_fn(cfg, accum, ruleset)(
            state["params"], batches[0])
    finally:
        moe.moe_apply = orig
    step = steps.make_train_step(cfg, accum_steps=accum,
                                 compress_grads=case.get("compress", False),
                                 error_feedback=ef, ruleset=ruleset)
    metrics = []
    for b in batches:
        state, m = step(state, b)
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics, "grads": whole(grads, cfg, ruleset),
            "params": whole(state["params"], cfg, ruleset),
            "drops": drops, "traffic": step.traffic,
            "batch_axes": list(tm.batch_axes)}


def train_cases(rank, world, cases, refused):
    """``train_case`` for every case (their meshes have ``world``
    ranks), and what a model axis does with ``refused``."""
    sharding._FSDP_MIN_ELEMENTS = FSDP_MIN_ELEMENTS
    return {"cases": [train_case(c) for c in cases],
            "refusals": model_axis_refusals(world, refused)}


def model_axis_refusals(world, archs):
    """Each config's loss under a (1, world) mesh, or the message its
    step raises: the configs a model axis used to refuse."""
    mesh = mesh_lib.make_mesh((1, world), AXES[2])
    ruleset = sharding.Ruleset(mesh=mesh)
    out = []
    for arch in archs:
        cfg = configs.get_smoke(arch)
        params = steps.init_state(cfg, 0, "cpu", ruleset=ruleset).params
        tokens, labels = SyntheticLMData(DataConfig(
            vocab=cfg.vocab, seq_len=8, global_batch=2)).batch_at(0)
        batch = {"tokens": torch.from_numpy(tokens),
                 "labels": torch.from_numpy(labels)}
        if cfg.n_frontend_tokens:
            batch["frontend"] = torch.zeros(2, cfg.n_frontend_tokens,
                                            cfg.d_model)
        try:
            out.append(float(steps.make_grad_fn(cfg, 1, ruleset)(
                params, batch)[0]))
        except NotImplementedError as e:
            out.append(str(e))
    return out


# ----------------------------------------------------------------------------
# GPipe
# ----------------------------------------------------------------------------

def tanh_layer(wb, x):
    return torch.tanh(x @ wb["w"] + wb["b"])


def gpipe_rank(rank, world, ws, micro):
    """The pipelined stack of ``tanh_layer`` over a ("stage",) mesh of
    every rank; and whether a stage dim of world + 1 raises."""
    mesh = mesh_lib.make_mesh((world,), ("stage",))
    fn = pipeline.gpipe(tanh_layer, mesh, axis="stage")
    ws_t = {k: torch.from_numpy(v) for k, v in ws.items()}
    out = fn(ws_t, torch.from_numpy(micro)).numpy()
    bad = {k: torch.cat([v, v[:1]]) for k, v in ws_t.items()}
    try:
        fn(bad, torch.from_numpy(micro))
        raised = None
    except ValueError as e:
        raised = str(e)
    return {"out": out, "raised": raised}


# ----------------------------------------------------------------------------
# Elastic checkpoints
# ----------------------------------------------------------------------------

def elastic_restore(rank, world, directory, tree_np, meshes):
    """The unsharded checkpoint in ``directory`` restored onto each FSDP
    mesh: each leaf's shard, the slice its ``param_spec`` names (cut
    here by hand from the saved array), and the leaf gathered back."""
    tree = {k: {n: torch.from_numpy(a) for n, a in v.items()}
            for k, v in tree_np.items()}
    out = []
    for shape in meshes:
        mesh = mesh_lib.make_mesh(shape, AXES[2])
        rs = sharding.Ruleset(mesh=mesh, fsdp=True)
        like = {k: {n: sharding.local_shard(a, sharding.param_spec(
            (n,), tuple(a.shape), rs), mesh).zero_() for n, a in v.items()}
            for k, v in tree.items()}
        got, manifest = CheckpointManager(directory).restore(like,
                                                             ruleset=rs)
        leaves = {}
        for k, v in got.items():
            for n, shard in v.items():
                spec = sharding.param_spec((n,), tuple(tree[k][n].shape), rs)
                want = tree[k][n]
                for dim, axis in enumerate(spec):
                    if axis is not None:
                        size = want.shape[dim] // mesh.shape[axis]
                        want = want.narrow(dim, mesh.index(axis) * size,
                                           size)
                leaves[f"{k}/{n}"] = {
                    "spec": list(spec),
                    "shard_equal": bool(torch.equal(shard, want)),
                    "gathered": sharding.gather_leaf(shard, spec,
                                                     mesh).numpy()}
        out.append({"shape": list(shape), "step": manifest["step"],
                    "leaves": leaves})
    return out


def _trainer_args(steps_, ckpt):
    return types.SimpleNamespace(
        lr=3e-3, warmup=4, steps=steps_, accum=1, seed=0, fsdp=True,
        compress_grads=False, error_feedback=False, ckpt=ckpt)


def run_trainer(arch, steps_, ckpt, device="cpu", mesh=None, every=2):
    """``launch.train.build`` and the trainer to ``steps_`` (checkpoints
    every ``every``, every step logged); returns the logged metrics."""
    cfg = configs.get_smoke(arch)
    args = _trainer_args(steps_, ckpt)
    step_fn, init_fn = launch.build(cfg, args, device, mesh)
    data = SyntheticLMData(DataConfig(vocab=cfg.vocab, seq_len=16,
                                      global_batch=4, seed=0))
    trainer = Trainer(TrainerConfig(checkpoint_dir=ckpt, total_steps=steps_,
                                    checkpoint_every=every, log_every=1),
                      cfg, data, step_fn, init_fn, device=device,
                      ruleset=launch.train_ruleset(mesh, True))
    return [{k: float(v) for k, v in m.items()}
            for m in trainer.run()["metrics"]]


def elastic_resume(rank, world, root, arch):
    """A (2, 1) FSDP run saves at step 2; copies of its checkpoint are
    made for this test's one-rank resume; the run resumed on (1, 2) takes
    step 3; an uninterrupted (2, 1) FSDP run takes steps 1-3. Returns
    both runs' metrics and the checkpoint's leaf shapes."""
    sharding._FSDP_MIN_ELEMENTS = FSDP_MIN_ELEMENTS
    fsdp = mesh_lib.make_mesh((2, 1), AXES[2])
    run = os.path.join(root, "run")
    first = run_trainer(arch, 2, run, mesh=fsdp)
    if rank == 0:
        shutil.copytree(run, os.path.join(root, "one_rank"))
    dist.barrier()
    resumed = run_trainer(arch, 3, run, mesh=mesh_lib.make_mesh((1, 2),
                                                                AXES[2]))
    fresh = run_trainer(arch, 3, os.path.join(root, "fresh"), mesh=fsdp,
                        every=3)
    return {"first": first, "resumed": resumed, "fresh": fresh}
