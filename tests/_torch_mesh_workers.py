"""Rank functions for ``tests/test_torch_mesh_decode.py``,
``tests/test_torch_remat.py`` and ``tests/test_torch_dryrun.py``: each
runs in a process that ``repro_torch.launch.mesh.run_ranks`` spawned and
joined to a gloo group, and returns plain Python values. This module
imports neither JAX nor the reference."""

import dataclasses

import numpy as np
import torch

from repro_torch import configs
from repro_torch.bridge import params_from_jax
from repro_torch.dist import sharding
from repro_torch.core import op_analysis
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.train import steps
from repro_torch.tree import tree_items, tree_map


def port_cfg(case):
    return dataclasses.replace(configs.get_smoke(case["arch"]),
                               **case.get("fields", {}))


def _rows(ruleset, batch):
    """(first row, rows) of the global batch this rank's slots hold."""
    (n,), (spec,) = sharding.local_shape(ruleset, ("batch",), (batch,))
    i = 0 if spec is None else sharding._block(spec, ruleset.mesh)[2]
    return i * n, n


def decode_case(case, params):
    """A prefill of ``case["prompt"]`` and one decode step a token of
    ``case["steps"]``, this rank's shard of the parameters and the
    contiguous caches on a (data, model) mesh of ``case["shape"]`` under
    the serving ruleset (``case["rules"]``); returns this rank's rows of
    the batch and the fp32 logits of every call."""
    cfg = port_cfg(case)
    mesh = mesh_lib.make_mesh(case["shape"], ("data", "model"))
    ruleset = sharding.Ruleset(mesh=mesh, rules=case.get("rules", {}))
    full = params_from_jax(params, cfg, device="cpu", dtype=torch.float32)
    local = sharding.shard_tree(full, mesh, ruleset)
    prompt = np.asarray(case["prompt"])
    b = prompt.shape[0]
    r0, n = _rows(ruleset, b)
    caches = T.init_caches(cfg, b, case["max_len"], device="cpu",
                           ruleset=ruleset)
    cross = None
    if case.get("frontend") is not None:
        cross = torch.from_numpy(np.asarray(case["frontend"])[r0:r0 + n])
    out = []
    with torch.no_grad(), sharding.use_ruleset(ruleset):
        tokens = torch.from_numpy(prompt[r0:r0 + n])
        logits, caches = T.forward(local, cfg, tokens, caches=caches,
                                   cross_kv=cross)
        out.append(logits.numpy().copy())
        for tok in case["steps"]:
            step = torch.from_numpy(np.asarray(tok)[r0:r0 + n, None])
            logits, caches = T.forward(local, cfg, step, caches=caches,
                                       cross_kv=cross)
            out.append(logits.numpy().copy())
    return {"rows": (r0, n), "logits": out,
            "spec": [list(c["spec"]) for c in caches if "spec" in c][:1]}


def decode_group(rank, world, cases, params):
    """Every case of this world size, in order."""
    torch.manual_seed(0)
    return [decode_case(c, params[c["arch_key"]]) for c in cases]


def remat_group(rank, world, cases, params, batch):
    """Each case's gradients (this rank's shards) on a (data, model) mesh
    of ``case["shape"]`` under the training ruleset, with the case's
    remat fields: its loss and {path: gradient}."""
    out = []
    for case in cases:
        cfg = port_cfg(case)
        mesh = mesh_lib.make_mesh(case["shape"], ("data", "model"))
        ruleset = sharding.Ruleset(mesh=mesh)
        full = params_from_jax(params[case["arch_key"]], cfg, device="cpu",
                               dtype=torch.float32)
        local = sharding.shard_tree(full, mesh, ruleset)
        loss, _, grads, _ = steps.make_grad_fn(cfg, ruleset=ruleset)(
            local, {k: torch.from_numpy(v)
                    for k, v in batch[case["arch_key"]].items()})
        out.append({"loss": float(loss),
                    "grads": {k: v.numpy().copy()
                              for k, v in tree_items(grads)}})
    return out


def census_rank(rank, world, case):
    """One train step of ``case`` traced on this rank of a real gloo
    group, CPU tensors: the collectives' (kind, group size, payload) in
    order, and the ops' census."""
    return census(case)


def census(case):
    """The train step of a smoke config on a (data, model) mesh of
    ``case["shape"]`` over the group that is initialised (real or fake),
    on ``case["device"]``, traced: its collectives and census."""
    cfg = dataclasses.replace(port_cfg(case), remat=case.get("remat", False))
    mesh = mesh_lib.make_mesh(case["shape"], ("data", "model"))
    ruleset = sharding.Ruleset(mesh=mesh, fsdp=case.get("fsdp", False))
    dev = torch.device(case["device"])
    full = T.init_params(cfg, torch.Generator(device="cpu").manual_seed(0),
                         device="cpu", dtype=torch.float32)
    params = sharding.shard_tree(full, mesh, ruleset)

    def to(t):
        return torch.empty_like(t, device=dev) if dev.type == "meta" else t

    params = tree_map(to, params)
    state = steps.TrainState(params=params, opt=adamw.adamw_init(params),
                             step=torch.zeros((), dtype=torch.int32,
                                              device=dev)).tree()
    b, s = case["batch"]
    tokens = torch.zeros((b, s), dtype=torch.int32, device=dev)
    batch = {"tokens": tokens, "labels": tokens}
    trace = op_analysis.OpTrace()
    trace.run(steps.make_train_step(cfg, ruleset=ruleset), state, batch)
    return {"collectives": [(op.kind, op.group, op.payload)
                            for op in trace.ops if op.kind is not None],
            "census": op_analysis.op_census(trace),
            "flops": op_analysis.trace_flops(trace)}
