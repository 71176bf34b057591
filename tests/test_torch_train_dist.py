"""Training over ranks in the PyTorch port (``train/dist.py``, the
layers under a training model axis, the vocab-sharded loss, MoE routing
over the whole batch, ``make_train_step(..., ruleset=)``) against the
reference's jitted single-device ``make_train_step`` on the same
parameters and batches.

Each group of gloo CPU ranks is started once by
``launch.mesh.run_ranks`` (rank functions in
``tests/_torch_train_workers.py``, one intra-op thread a rank) and runs
every case of its size; the reference runs here under
``JAX_PLATFORMS=cpu`` and its parameters cross through
``bridge.params_from_jax``. FSDP shards leaves of 256 elements and more
in the ranks (the rules' 65,536 would leave every smoke leaf whole).

Cases: qwen3-4b smoke on (data 2, model 1) FSDP, (1, 2) (heads, kv
heads, mlp and vocab split), (2, 2) FSDP, (1, 4) (the 4 q heads split,
the 2 kv heads replicated) and (pod 2, data 2, model 1); int8
compression with error feedback under (2, 1) FSDP; ``accum`` 2 under
(2, 1); dbrx-132b smoke routed by capacity at factor 0.5 (drops) under
(2, 1) and (4, 1); jamba smoke (cut to a Mamba layer with experts and
an attention layer) and whisper smoke under (2, 1) FSDP. A model
axis of 2 takes a step of MoE, Mamba, cross and encoder configs
(``tests/test_torch_expert_parallel.py`` and
``tests/test_torch_model_axis_families.py`` hold them to the
reference).

Tolerances. Losses (and the aux loss) within 1e-5 relative of the
reference's: the ranks reorder fp32 sums. First-step gradients, gathered
whole, within 1e-4 of each leaf's largest element (a leaf whose
gradient is zero up to rounding, ``b_k`` under the softmax's invariance
to a shift of every score, is held at 1e-3 of the largest element of
the whole gradient: its noise has no scale of its own). Parameters after two
steps within 2 * lr * steps absolute plus 1e-5 relative: at step 1
AdamW's m_hat / sqrt(v_hat) is sign(g), so an element whose gradient is
near zero moves by up to 2 lr the other way when the two frameworks
round its gradient to opposite signs (and int8 compression may round an
element on a step boundary the other way).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import moe as jmoe
from repro.train import steps as jsteps

from repro_torch.bridge import params_from_jax
from repro_torch.data import DataConfig, SyntheticLMData
from repro_torch.launch import mesh as mesh_lib
from repro_torch.tree import tree_items

import _torch_train_workers as workers

DEADLINE_S = 120.0
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
ZERO_GRAD = 1e-3
PARAM_RTOL = 1e-5
N_STEPS = 2
BATCH, SEQ = 8, 16
CAPACITY = dict(moe_impl="capacity", moe_capacity_factor=0.5)
# jamba smoke cut to one period of a Mamba layer with experts and an
# attention layer: the reference compiles the 8-layer pattern in ~30 s.
JAMBA_CUT = dict(pattern=("mamba", "attn"), n_layers=2, moe_positions=(0,))

# name -> (arch, config fields, mesh shape, fsdp, accum, compress+ef)
CASES = {
    "qwen3_data2_fsdp": ("qwen3-4b", {}, (2, 1), True, 1, False),
    "qwen3_model2": ("qwen3-4b", {}, (1, 2), False, 1, False),
    "qwen3_data2_model2_fsdp": ("qwen3-4b", {}, (2, 2), True, 1, False),
    "qwen3_model4_kv_replicated": ("qwen3-4b", {}, (1, 4), False, 1, False),
    "qwen3_pod2_data2": ("qwen3-4b", {}, (2, 2, 1), False, 1, False),
    "qwen3_data2_fsdp_compress_ef": ("qwen3-4b", {}, (2, 1), True, 1, True),
    "qwen3_data2_accum2": ("qwen3-4b", {}, (2, 1), False, 2, False),
    "dbrx_data2": ("dbrx-132b", CAPACITY, (2, 1), False, 1, False),
    "dbrx_data4": ("dbrx-132b", CAPACITY, (4, 1), False, 1, False),
    "jamba_data2_fsdp": ("jamba-v0.1-52b", JAMBA_CUT, (2, 1), True, 1,
                         False),
    "whisper_data2_fsdp": ("whisper-medium", {}, (2, 1), True, 1, False),
}
REFUSED = ["dbrx-132b", "jamba-v0.1-52b", "llama-3.2-vision-90b",
           "whisper-medium"]


def _batches(cfg):
    out = []
    for i in range(N_STEPS):
        tokens, labels = SyntheticLMData(DataConfig(
            vocab=cfg.vocab, seq_len=SEQ, global_batch=BATCH)).batch_at(i)
        b = {"tokens": tokens, "labels": labels}
        if cfg.n_frontend_tokens:
            b["frontend"] = np.random.RandomState(i).randn(
                BATCH, cfg.n_frontend_tokens, cfg.d_model).astype(np.float32)
        out.append(b)
    return out


def _reference(arch, fields, accum, ef):
    """The reference's numpy parameters, its metrics and parameters after
    N_STEPS jitted steps, its first-step gradients (averaged over the
    micro-batches) and the drops of each mixture call of the first."""
    jcfg = dataclasses.replace(jconfigs.get_smoke(arch), **fields)
    jstate = jsteps.init_state(jax.random.PRNGKey(0), jcfg,
                               error_feedback=ef).tree()
    np_params = jax.tree.map(np.asarray, jstate["params"])
    batches = _batches(jcfg)
    jb = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]
    n = BATCH // accum
    step = jsteps.make_train_step(jcfg, accum_steps=accum,
                                  compress_grads=ef, error_feedback=ef)

    def grads_and_step(state, batch):
        # One compile for both: the micro-batches' mean gradient, and the
        # jitted step.
        grads = None
        for i in range(accum):
            mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
            _, g = jax.value_and_grad(jsteps.loss_fn, has_aux=True)(
                state["params"], jcfg, mb)
            grads = g if grads is None else jax.tree.map(jnp.add, grads, g)
        return jax.tree.map(lambda g: g / accum, grads), step(state, batch)

    run = jax.jit(grads_and_step)
    metrics, grads = [], None
    drops = _reference_drops(jstate["params"], jcfg, jb[0], accum)
    for b in jb:
        g, (jstate, m) = run(jstate, b)
        grads = jax.tree.map(np.asarray, g) if grads is None else grads
        metrics.append({k: float(v) for k, v in m.items()})
    return {"np_params": np_params, "batches": batches, "grads": grads,
            "metrics": metrics, "drops": drops,
            "params": jax.tree.map(np.asarray, jstate["params"])}


def _reference_drops(params, jcfg, batch, accum):
    """The choices the reference's capacity routing drops in each mixture
    call of a forward over ``batch``'s micro-batches: its router's ids,
    handed out of the jitted forward in order (an ordered
    ``jax.debug.callback``), counted against its capacity."""
    drops = []
    if not jcfg.n_experts:
        return drops
    orig = jmoe._route

    def count(ids, cap):
        counts = np.bincount(np.asarray(ids).reshape(-1),
                             minlength=jcfg.n_experts)
        drops.append(int(np.maximum(counts - cap, 0).sum()))

    def route(p, cfg, x):
        weights, ids, aux = orig(p, cfg, x)
        t, e, k = x.shape[0], cfg.n_experts, cfg.top_k
        cap = max(int(np.ceil(t * k / e * cfg.capacity_factor)), 4)
        jax.debug.callback(count, ids, cap, ordered=True)
        return weights, ids, aux

    n = BATCH // accum
    jmoe._route = route
    try:
        forward = jax.jit(lambda p, b: jsteps.loss_fn(p, jcfg, b)[0])
        for i in range(accum):
            forward(params, {k: v[i * n:(i + 1) * n]
                             for k, v in batch.items()}).block_until_ready()
        jax.effects_barrier()
    finally:
        jmoe._route = orig
    return drops


def _flat(np_tree, cfg):
    return {k: v.numpy() for k, v in tree_items(params_from_jax(
        np_tree, cfg, device="cpu", dtype=torch.float32))}


@pytest.fixture(scope="module")
def runs():
    """Every case's reference and rank results (one group of 2 ranks and
    one of 4 run all the cases of their size), and the refusals."""
    refs, cases = {}, {}
    for name, (arch, fields, shape, fsdp, accum, ef) in CASES.items():
        key = (arch, tuple(sorted(fields.items())), accum, ef)
        if key not in refs:
            refs[key] = _reference(arch, fields, accum, ef)
        ref = refs[key]
        cases[name] = dict(arch=arch, fields=fields, shape=shape, fsdp=fsdp,
                           accum=accum, compress=ef, ef=ef,
                           np_params=ref["np_params"],
                           batches=ref["batches"])
    got = {}
    for world in (2, 4):
        names = [n for n, c in cases.items()
                 if math.prod(c["shape"]) == world]
        ranks = mesh_lib.run_ranks(
            workers.train_cases, world, args=(
                [cases[n] for n in names], REFUSED if world == 2 else []),
            deadline_s=DEADLINE_S)
        for i, n in enumerate(names):
            got[n] = [r["cases"][i] for r in ranks]
        if world == 2:
            refusals = [r["refusals"] for r in ranks]
    out = {}
    for name, (arch, fields, shape, fsdp, accum, ef) in CASES.items():
        ref = refs[(arch, tuple(sorted(fields.items())), accum, ef)]
        out[name] = (cases[name], ref, got[name])
    return out, refusals


@pytest.mark.parametrize("name", list(CASES))
def test_losses_match_the_reference(runs, name):
    """Every rank logs the global loss, nll and aux of each step, within
    LOSS_RTOL of the reference's, and the same learning rate."""
    case, ref, ranks = runs[0][name]
    for r in ranks:
        for got, want in zip(r["metrics"], ref["metrics"]):
            for k in ("loss", "nll", "aux", "grad_norm"):
                assert got[k] == pytest.approx(want[k], rel=LOSS_RTOL,
                                               abs=1e-7), (k, got, want)
            assert got["lr"] == pytest.approx(want["lr"], rel=1e-6)
    assert ranks[0]["metrics"] == ranks[-1]["metrics"]


@pytest.mark.parametrize("name", list(CASES))
def test_first_gradients_match_the_reference(runs, name):
    """The first batch's gradients, averaged over the batch axes and
    gathered whole, leaf by leaf within GRAD_TOL of the leaf's largest
    reference element; each rank holds the same whole gradients."""
    case, ref, ranks = runs[0][name]
    cfg = workers.port_cfg(case)
    want = _flat(ref["grads"], cfg)
    floor = ZERO_GRAD * max(float(np.abs(w).max()) for w in want.values())
    for r in ranks:
        assert r["grads"].keys() == want.keys()
        for key, w in want.items():
            scale = max(float(np.abs(w).max()), floor)
            err = float(np.abs(r["grads"][key] - w).max())
            assert err <= GRAD_TOL * scale, (key, err, scale)
    shape = case["shape"]
    assert ranks[0]["batch_axes"] == [
        a for a, n in zip(workers.AXES[len(shape)], shape)
        if a != "model" and n > 1]


@pytest.mark.parametrize("name", list(CASES))
def test_parameters_after_two_steps_match_the_reference(runs, name):
    case, ref, ranks = runs[0][name]
    cfg = workers.port_cfg(case)
    want = _flat(ref["params"], cfg)
    lr = max(m["lr"] for m in ref["metrics"])
    for r in ranks:
        for key, w in want.items():
            np.testing.assert_allclose(
                r["params"][key], w, rtol=PARAM_RTOL,
                atol=2 * lr * N_STEPS, err_msg=key)


@pytest.mark.parametrize("name", ["dbrx_data2", "dbrx_data4"])
def test_capacity_drops_span_the_whole_batch(runs, name):
    """Every mixture call of the first gradient drops, over all ranks,
    the choices the reference's routing of the whole batch drops (the
    global capacity and the global order), and some are dropped."""
    _, ref, ranks = runs[0][name]
    assert sum(ref["drops"]) > 0
    for r in ranks:
        assert r["drops"] == ref["drops"]


def test_a_model_axis_refuses_experts_mamba_and_cross_layers(runs):
    """Nothing is refused any more: a (1, 2) step of each config that the
    model axis used to refuse runs to a finite loss."""
    for r in runs[1]:
        assert len(r) == len(REFUSED)
        for arch, got in zip(REFUSED, r):
            assert isinstance(got, float) and math.isfinite(got), (arch, got)


def test_collectives_are_counted(runs):
    """The step's traffic: a (1, 2) step reduces activations over the
    model axis; a (2, 1) FSDP step gathers leaves and averages
    gradients."""
    for name in ("qwen3_model2", "qwen3_data2_fsdp"):
        traffic = runs[0][name][2][0]["traffic"]
        assert traffic["collectives"] > 0 and traffic["bytes"] > 0
