"""Mamba, hybrid, cross-attention and encoder layers trained over a
model axis in the PyTorch port, against the reference's single-device
step.

Ranks are gloo CPU processes started by ``launch.mesh.run_ranks`` with
one intra-op thread each (rank functions in
``tests/_torch_model_axis_workers.py``, no JAX); one group a world size
(2, 3 and 4 ranks) runs every case of its size. The reference runs here
under ``JAX_PLATFORMS=cpu``; its parameters cross through
``bridge.params_from_jax``, and the gate, biases and LayerNorm's bias,
zero at init, are first set to seeded non-zero values (as
``tests/test_torch_encdec_train.py`` sets them).

Cases, each at (data 1, model 2), (1, 4) and (2, 2) over ``("data",
"model")``:

* mamba2-370m smoke (8 SSM heads of 8: 4 and 2 a rank; the gated norm's
  sum of squares summed over the ranks);
* jamba smoke (8 layers: Mamba mixers split by heads, the mixtures by
  experts, the attention layer by heads);
* llama-3.2-vision smoke (the gated cross-attention split by heads, the
  2 kv heads replicated at model 4);
* whisper smoke's ``encode`` (non-causal, RoPE-less, LayerNorm and GELU
  blocks split by heads and ``mlp``): its output, and the gradient of
  ``sum(encode * w)`` for a seeded ``w``.

Also: mamba2-370m smoke at (1, 3), where the 8 SSM heads do not divide
the axis and the mixer runs whole on every rank; the norm's sum of
squares planted local only (this rank's heads), which must break the
gradients; one train step with int8 compression at (2, 2) for jamba
(the experts' and the Mamba leaves' scales and the global norm taken
over their shard axes); and a checkpoint of a dbrx smoke and a
mamba2-370m smoke state saved at model 2 and restored at model 2 and on
one rank.

Tolerances: loss within 1e-6 relative of the reference's. Gradients,
gathered whole, are held twice. (1) To the port's own one-rank
gradients on the same inputs, within 1e-5 of each leaf's largest
element: this isolates what the split adds (a leaf whose gradient is
zero up to rounding, ``b_k`` under the softmax's invariance to a shift
of every score, is scaled by 1e-2 of the largest element of the whole
gradient instead, so held to 1e-7 of it: its noise has no scale of its
own). jamba's are held at 2e-4, as in
``tests/test_torch_train_families.py``: its random 8-layer stack is
ill-conditioned in fp32, and the ranks' reordered sums move its Mamba
leaves by up to 3e-5 of their largest element. (2) To the reference's,
within the one-rank port's own distance from them plus the same
tolerance: the two frameworks' fp32 sums already differ through the
chunked scan (``A_log``'s gradient, a sum over every position, by
1.05e-5 of its largest element for mamba2-370m smoke and 2.4e-4 for
jamba smoke on these inputs), and the split may add no more than (1)
allows. ``encode``'s output within 1e-5 of its largest element of
both. The compressed step's global norm within jamba's 2e-4 of the
one-rank port's (an int8 code moves by a level where the ranks' sums
move an element across a rounding boundary), its parameters
against the one-rank port's step within 2 * lr absolute (at step 1 AdamW
moves an element by about lr times the sign of its gradient, so an
element whose gradient is near zero, or whose int8 code sits on a
rounding boundary, may move the other way).
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import transformer as JT
from repro.train import steps as jsteps

from repro_torch.bridge import params_from_jax
from repro_torch.checkpoint import CheckpointManager
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.train import steps
from repro_torch.tree import tree_items

import _torch_model_axis_workers as workers

DEADLINE_S = 120.0
LOSS_RTOL = 1e-6
GRAD_TOL = 1e-5
ZERO_GRAD = 1e-2
JAMBA_GRAD_TOL = 2e-4
B, SEQ = 4, 16
ZERO_AT_INIT = ("gate", "bias", "b_q", "b_k", "b_v", "b_up")
SHAPES = {"1x2": (1, 2), "1x4": (1, 4), "2x2": (2, 2)}
ARCHS = {"mamba": "mamba2-370m", "jamba": "jamba-v0.1-52b",
         "vision": "llama-3.2-vision-90b", "whisper": "whisper-medium"}
CASES = {f"{a}_{s}": dict(kind="encode" if a == "whisper" else "grad",
                          arch=ARCHS[a], shape=SHAPES[s])
         for a in ARCHS for s in SHAPES}
CASES["mamba_1x3_replicated"] = dict(kind="grad", arch=ARCHS["mamba"],
                                     shape=(1, 3))
CASES["mamba_1x2_norm_local"] = dict(kind="grad", arch=ARCHS["mamba"],
                                     shape=(1, 2), plant="norm_local")
CASES["jamba_2x2_compressed_step"] = dict(
    kind="grad", arch=ARCHS["jamba"], shape=(2, 2), step=True,
    compress=True)
CHECKPOINTED = ("dbrx-132b", "mamba2-370m")


def nonzero_init(tree, seed=1):
    """The reference's parameters as numpy, the gate set to 0.5 plus
    noise and biases to 0.1 times a standard normal."""
    rng = np.random.RandomState(seed)

    def leaf(path, a):
        name, a = getattr(path[-1], "key", None), np.array(a)
        if name == "gate":
            return np.asarray(0.5 + 0.1 * rng.randn(*a.shape), np.float32)
        if name in ZERO_AT_INIT:
            return np.asarray(0.1 * rng.randn(*a.shape), np.float32)
        return a

    return jax.tree_util.tree_map_with_path(leaf, tree)


def _flat(np_tree, arch):
    cfg = workers.port_cfg(dict(arch=arch))
    return {k: v.numpy() for k, v in tree_items(params_from_jax(
        np_tree, cfg, device="cpu", dtype=torch.float32))}


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """The reference's numpy parameters (seeded non-zero where init left
    zeros), its batch, and its loss, aux and gradients (flat, as the
    port's tree) of the cache-less ``loss_fn``; for whisper, its
    frontend, weights, ``encode`` output and that output's gradients."""
    jcfg = jconfigs.get_smoke(arch)
    params = nonzero_init(JT.init_params(jax.random.PRNGKey(0), jcfg))
    jparams = jax.tree.map(jnp.asarray, params)
    rng = np.random.RandomState(2)
    if jcfg.encoder is not None:
        frontend = rng.randn(B, jcfg.n_frontend_tokens,
                             jcfg.d_model).astype(np.float32)
        weights = rng.randn(*frontend.shape).astype(np.float32)

        def f(p):
            y = JT.encode(p, jcfg, jnp.asarray(frontend))
            return jnp.sum(y * weights), y

        (_, y), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(
            jparams)
        inputs = dict(frontend=frontend, weights=weights)
        return params, inputs, dict(
            encode=np.asarray(y),
            grads={k: v for k, v in _flat(jax.tree.map(np.asarray, grads),
                                          arch).items()
                   if k.startswith("encoder/")},
            one=_one_rank(arch, params, inputs, encode=True))
    batch = {"tokens": rng.randint(0, jcfg.vocab, (B, SEQ)).astype(np.int32),
             "labels": rng.randint(0, jcfg.vocab, (B, SEQ)).astype(np.int32)}
    if jcfg.n_frontend_tokens:
        batch["frontend"] = rng.randn(B, jcfg.n_frontend_tokens,
                                      jcfg.d_model).astype(np.float32)
    (loss, parts), grads = jax.jit(jax.value_and_grad(
        lambda p, b: jsteps.loss_fn(p, jcfg, b), has_aux=True))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    return params, batch, dict(loss=float(loss), aux=float(parts["aux"]),
                               grads=_flat(jax.tree.map(np.asarray, grads),
                                           arch),
                               one=_one_rank(arch, params, batch))


def _one_rank(arch, params, inputs, encode=False):
    """The port's one-rank gradients (and ``encode`` output) of the same
    parameters and inputs."""
    cfg = workers.port_cfg(dict(arch=arch))
    full = params_from_jax(params, cfg, device="cpu", dtype=torch.float32)
    tracked = {k: v.requires_grad_() for k, v in tree_items(full)}
    if encode:
        y = T.encode(full, cfg, torch.from_numpy(inputs["frontend"]))
        keys = [k for k in tracked if k.startswith("encoder/")]
        g = torch.autograd.grad(
            (y * torch.from_numpy(inputs["weights"])).sum(),
            [tracked[k] for k in keys])
        return dict(encode=y.detach().numpy(),
                    grads={k: v.numpy() for k, v in zip(keys, g)})
    loss, _, grads, _ = steps.make_grad_fn(cfg)(
        full, {k: torch.from_numpy(v) for k, v in inputs.items()})
    return dict(loss=float(loss),
                grads={k: v.numpy() for k, v in tree_items(grads)})


def _one_rank_step(case, params, batch):
    """The port's one-rank step (compressed as the case) from the same
    parameters: its metrics and parameters."""
    cfg = workers.port_cfg(case)
    full = params_from_jax(params, cfg, device="cpu", dtype=torch.float32)
    state = steps.TrainState(params=full, opt=adamw.adamw_init(full),
                             step=torch.zeros((), dtype=torch.int32)).tree()
    step = steps.make_train_step(cfg, compress_grads=case.get("compress",
                                                              False))
    state, m = step(state, {k: torch.from_numpy(v) for k, v in
                            batch.items()})
    return ({k: float(v) for k, v in m.items()},
            {k: v.numpy() for k, v in tree_items(state["params"])})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case's reference and its ranks' results, and the
    checkpoints saved at model 2."""
    cases = {}
    for name, case in CASES.items():
        params, batch, _ = _reference(case["arch"])
        c = dict(case, params=params)
        if case["kind"] == "encode":
            c.update(batch)
        else:
            c["batch"] = batch
        cases[name] = c
    got = {}
    ckpt = str(tmp_path_factory.mktemp("ckpt"))
    for world in (2, 3, 4):
        names = [n for n, c in cases.items()
                 if math.prod(c["shape"]) == world]
        ranks = mesh_lib.run_ranks(
            workers.model_axis_group, world,
            args=([cases[n] for n in names],
                  CHECKPOINTED if world == 2 else (), ckpt),
            deadline_s=DEADLINE_S)
        for i, n in enumerate(names):
            got[n] = [r["cases"][i] for r in ranks]
        if world == 2:
            saved = [r["checkpoints"] for r in ranks]
    return cases, got, saved, ckpt


def _check_grads(got, want, tol, base=None):
    """Each leaf of ``got`` within ``tol`` of ``want``'s largest element
    (floored), plus ``base``'s own distance from ``want`` where given."""
    floor = ZERO_GRAD * max(float(np.abs(w).max()) for w in want.values())
    assert got.keys() == want.keys()
    for key, w in want.items():
        scale = max(float(np.abs(w).max()), floor)
        err = float(np.abs(got[key] - w).max())
        slack = 0.0 if base is None else float(np.abs(base[key] - w).max())
        assert err <= tol * scale + slack, (key, err, scale, slack)


@pytest.mark.parametrize("name", [n for n, c in CASES.items()
                                  if "plant" not in c])
def test_model_axis_matches_the_reference_single_device(runs, name):
    """Every rank's loss and gradients (gathered whole), or whisper's
    encoder output and gradients, against the port's one-rank ones and
    the reference's."""
    case = CASES[name]
    _, _, want = _reference(case["arch"])
    one = want["one"]
    tol = JAMBA_GRAD_TOL if case["arch"] == ARCHS["jamba"] else GRAD_TOL
    for r in runs[1][name]:
        _check_grads(r["grads"], one["grads"], tol)
        _check_grads(r["grads"], want["grads"], tol, base=one["grads"])
        if case["kind"] == "encode":
            for w in (one["encode"], want["encode"]):
                scale = float(np.abs(w).max())
                assert float(np.abs(r["encode"] - w).max()) \
                    <= GRAD_TOL * scale
        else:
            assert r["loss"] == pytest.approx(want["loss"], rel=LOSS_RTOL)
            assert r["aux"] == pytest.approx(want["aux"], rel=LOSS_RTOL,
                                             abs=1e-7)


@pytest.mark.parametrize("shape", ["1x2", "1x4"])
def test_mamba_mixer_splits_by_ssm_heads(runs, shape):
    """The mixer's head leaves are split over "model"; w_B, w_C and the
    norm's scale replicate; a step's collectives are counted."""
    r = runs[1][f"mamba_{shape}"][0]
    specs = r["specs"]
    for leaf in ("w_x", "w_z", "w_dt", "dt_bias", "A_log", "D", "conv_w",
                 "w_ssm_out"):
        assert "model" in specs[f"blocks/0/mamba/{leaf}"], leaf
    for leaf in ("w_B", "w_C", "norm/scale"):
        assert f"blocks/0/mamba/{leaf}" not in specs, leaf
    assert r["traffic"]["collectives"] > 0


def test_mamba_mixer_replicates_where_its_heads_do_not_divide(runs):
    r = runs[1]["mamba_1x3_replicated"][0]
    assert not any("/mamba/" in k for k in r["specs"])


def test_norm_summed_over_this_ranks_heads_only_breaks_gradients(runs):
    _, _, want = _reference(ARCHS["mamba"])
    for r in runs[1]["mamba_1x2_norm_local"]:
        with pytest.raises(AssertionError):
            _check_grads(r["grads"], want["one"]["grads"], GRAD_TOL)
        with pytest.raises(AssertionError):
            _check_grads(r["grads"], want["grads"], GRAD_TOL,
                         base=want["one"]["grads"])


def test_compressed_step_over_experts_and_mamba_leaves(runs):
    """One int8-compressed step at (2, 2) takes the one-rank step's
    parameters, and its global norm equals the one-rank one."""
    case = runs[0]["jamba_2x2_compressed_step"]
    metrics, params = _one_rank_step(case, case["params"], case["batch"])
    for r in runs[1]["jamba_2x2_compressed_step"]:
        assert r["metrics"]["grad_norm"] == pytest.approx(
            metrics["grad_norm"], rel=JAMBA_GRAD_TOL)
        assert r["metrics"]["loss"] == pytest.approx(metrics["loss"],
                                                     rel=LOSS_RTOL)
        for key, w in params.items():
            np.testing.assert_allclose(r["params"][key], w, rtol=1e-5,
                                       atol=2 * metrics["lr"], err_msg=key)


@pytest.mark.parametrize("arch", CHECKPOINTED)
def test_checkpoint_at_model_2_restores_at_model_2_and_on_one_rank(runs,
                                                                   arch):
    saved, ckpt = runs[2], runs[3]
    cfg = workers.port_cfg(dict(arch=arch))
    for r in saved:
        got = r[arch]
        assert got["same"] and got["step"] == 1
        kinds = ("/moe/expert_", "/moe/router") if arch == "dbrx-132b" \
            else ("/mamba/w_x", "/mamba/w_ssm_out")
        for kind in kinds:
            assert any(kind in k for k in got["sharded"]), kind
    want = steps.init_state(cfg, 3, "cpu").tree()
    like = {k: v for k, v in want.items()}
    got, manifest = CheckpointManager(f"{ckpt}/{arch}").restore(like)
    assert manifest["step"] == 1
    for (key, a), (_, b) in zip(tree_items(got), tree_items(want)):
        assert torch.equal(a, b), key


def test_train_launcher_mesh_data1_model2_trains_as_one_rank(tmp_path):
    """``launch/train.py --mesh data=1,model=2`` spawns its two ranks and
    trains the mamba2-370m smoke to one rank's losses; an axis it does
    not know is refused."""
    from repro_torch.launch import train as launch

    args = ["--arch", "mamba2-370m", "--smoke", "--device", "cpu",
            "--steps", "3", "--batch", "2", "--seq", "16", "--warmup", "3",
            "--log-every", "1"]
    one = launch.main(args + ["--ckpt", str(tmp_path / "one")])
    two = launch.main(args + ["--ckpt", str(tmp_path / "two"), "--mesh",
                              "data=1,model=2"])
    assert [m["step"] for m in two["metrics"]] == [1, 2, 3]
    for a, b in zip(two["metrics"], one["metrics"]):
        assert a["loss"] == pytest.approx(float(b["loss"]), rel=LOSS_RTOL)
    with pytest.raises(SystemExit, match="AXIS=N"):
        launch.main(args + ["--ckpt", str(tmp_path / "bad"), "--mesh",
                            "expert=2"])
