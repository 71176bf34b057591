"""The training stack of the PyTorch port against the reference: AdamW,
clipping and the schedule, the synthetic data, int8 gradient compression,
the loss and its gradients, train steps with accumulation and
compression, and mirrors of the reference's checkpoint, trainer and
launcher tests (``tests/test_checkpoint_trainer.py``,
``tests/test_optim_data.py``).

Inputs are made with numpy from a seed and handed to both packages;
parameters cross through ``bridge.params_from_jax`` as fp32 masters.

Tolerances. Optimizer arithmetic: 1e-6 relative (the same fp32 formulas;
XLA and torch may fuse a multiply-add differently). Loss and gradients:
rtol 1e-4 (two frameworks' sums in another order through a 2-layer
model; the measured worst is about 1e-6 of each leaf's largest element).
Train steps: losses within 1e-4, parameters after three steps within a
tenth of the largest step's learning rate: at step 1 AdamW's
m_hat / sqrt(v_hat) is the sign of g, so an element whose gradient is
near zero may move by a fraction of lr differently in the two frameworks,
and with int8 compression an element on a rounding boundary of its
leaf's step may round the other way (measured worst: 8e-6 without
compression, 2.1e-5 with it, at lr 4.5e-4).
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticLMData as JSyntheticLMData
from repro.dist import compression as jcompression
from repro.launch import train as jlaunch
from repro.models import transformer as JT
from repro.optim import adamw as jadamw, schedule as jschedule
from repro.train import steps as jsteps

from repro_torch import configs
from repro_torch.bridge import params_from_jax
from repro_torch.checkpoint import (CheckpointManager, latest_step,
                                    load_checkpoint, save_checkpoint)
from repro_torch.data import DataConfig, SyntheticLMData
from repro_torch.dist import compression
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import train as launch
from repro_torch.optim import adamw, schedule
from repro_torch.train import steps
from repro_torch.train import trainer as trainer_module
from repro_torch.train.trainer import (SimulatedPreemption, Trainer,
                                       TrainerConfig)
from repro_torch.tree import tree_items, tree_map

ARCHS = ["qwen3-4b", "qwen2-0.5b"]
OPT_RTOL = 1e-6
LOSS_TOL = 1e-4
PARAM_ATOL_LR = 0.1


def _np_tree(seed, shapes):
    rng = np.random.RandomState(seed)
    return {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}


def _torch(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _close(got, want, rtol=OPT_RTOL, atol=0.0):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float32),
                               np.asarray(want, dtype=np.float32),
                               rtol=rtol, atol=atol)


# ----------------------------------------------------------------------------
# Optimizer and schedule
# ----------------------------------------------------------------------------

SHAPES = {"w": (4, 3), "b": (5,), "e": (7, 2)}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_adamw_update_matches_reference(seed):
    """Four AdamW steps on the same gradients: parameters, moments and
    count leaf by leaf against the reference's."""
    p = _np_tree(seed, SHAPES)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = _torch(p)
    jstate = jadamw.adamw_init(jp)
    tstate = adamw.adamw_init(tp)
    cfg = adamw.AdamWConfig()
    for step in range(4):
        g = _np_tree(100 * seed + step, SHAPES)
        lr = 0.01 * (step + 1)
        jp, jstate = jadamw.adamw_update({k: jnp.asarray(v)
                                          for k, v in g.items()},
                                         jstate, jp, lr, jadamw.AdamWConfig())
        tp, tstate = adamw.adamw_update(_torch(g), tstate, tp,
                                        torch.tensor(lr), cfg)
    assert int(tstate["count"]) == int(jstate["count"]) == 4
    assert tstate["count"].dtype == torch.int32
    for k in SHAPES:
        _close(tp[k], jp[k], atol=1e-7)
        _close(tstate["m"][k], jstate["m"][k], atol=1e-7)
        _close(tstate["v"][k], jstate["v"][k], atol=1e-7)
        assert tstate["m"][k].dtype == torch.float32


def test_adamw_matches_numpy_oracle():
    """The reference test's oracle, one step from zero moments."""
    rng = np.random.RandomState(7)
    p, g = rng.randn(4, 3).astype(np.float32), rng.randn(4, 3).astype(
        np.float32)
    cfg = adamw.AdamWConfig()
    tp = {"w": torch.from_numpy(p.copy())}
    new_p, _ = adamw.adamw_update({"w": torch.from_numpy(g)},
                                  adamw.adamw_init(tp), tp, 0.01, cfg)
    m, v = (1 - cfg.b1) * g, (1 - cfg.b2) * g * g
    mh, vh = m / (1 - cfg.b1), v / (1 - cfg.b2)
    want = p - 0.01 * (mh / (np.sqrt(vh) + cfg.eps) + cfg.weight_decay * p)
    np.testing.assert_allclose(new_p["w"].numpy(), want, rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("max_norm", [1.0, 100.0])
def test_clip_by_global_norm_matches_reference(max_norm):
    g = _np_tree(3, SHAPES)
    jc, jn = jadamw.clip_by_global_norm({k: jnp.asarray(v)
                                         for k, v in g.items()}, max_norm)
    tc, tn = adamw.clip_by_global_norm(_torch(g), max_norm)
    _close(tn, jn)
    for k in SHAPES:
        _close(tc[k], jc[k])
    if max_norm == 100.0:                # no-op below the threshold
        for k in SHAPES:
            np.testing.assert_array_equal(tc[k].numpy(), g[k])
    else:
        assert float(adamw.global_norm(tc)) == pytest.approx(1.0, rel=1e-5)


@pytest.mark.parametrize("kind", ["cosine", "linear", "constant"])
def test_learning_rate_matches_reference(kind):
    """fp32 rates at every step of a short run, in warmup and decay."""
    cfg = schedule.ScheduleConfig(peak_lr=1.0, warmup_steps=10,
                                  total_steps=100, kind=kind)
    jcfg = jschedule.ScheduleConfig(peak_lr=1.0, warmup_steps=10,
                                    total_steps=100, kind=kind)
    for step in range(0, 120, 3):
        got = schedule.learning_rate(torch.tensor(step, dtype=torch.int32),
                                     cfg)
        assert got.dtype == torch.float32 and got.dim() == 0
        _close(got, jschedule.learning_rate(step, jcfg))
    assert float(schedule.learning_rate(0, cfg)) == pytest.approx(0.1)
    assert float(schedule.learning_rate(9, cfg)) == pytest.approx(1.0)


# ----------------------------------------------------------------------------
# Data and compression
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("vocab,seq,batch,seed,ranks",
                         [(97, 16, 4, 3, 1), (151936, 33, 2, 0, 1),
                          (61, 8, 8, 1, 2)])
def test_data_batches_bit_equal_to_reference(vocab, seq, batch, seed, ranks):
    cfg = DataConfig(vocab=vocab, seq_len=seq, global_batch=batch, seed=seed)
    jcfg = JDataConfig(vocab=vocab, seq_len=seq, global_batch=batch,
                       seed=seed)
    for rank in range(ranks):
        mine = SyntheticLMData(cfg, dp_rank=rank, dp_size=ranks)
        theirs = JSyntheticLMData(jcfg, dp_rank=rank, dp_size=ranks)
        for step in (0, 5, 1000):
            for a, b in zip(mine.batch_at(step), theirs.batch_at(step)):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)


def test_data_resume_prefetch_and_shards():
    """The reference's pipeline tests: resume from a state dict, labels
    are the shifted tokens, prefetch equals the synchronous batch, and a
    sample does not depend on how the batch is sharded."""
    cfg = DataConfig(vocab=97, seq_len=16, global_batch=4, seed=3)
    d1 = SyntheticLMData(cfg)
    d1.step = 7
    d3 = SyntheticLMData(cfg)
    d3.load_state_dict(d1.state_dict())
    np.testing.assert_array_equal(next(d3)[0], d1.batch_at(7)[0])
    assert d3.step == 8
    tokens, labels = d1.batch_at(0)
    np.testing.assert_array_equal(tokens[:, 1:], labels[:, :-1])
    d2 = SyntheticLMData(cfg)
    d2.start_prefetch()
    pre = d2.next_prefetched()
    d2.stop()
    np.testing.assert_array_equal(pre[0], tokens)
    whole = SyntheticLMData(cfg, dp_rank=0, dp_size=1).batch_at(2)[0]
    halves = [SyntheticLMData(cfg, dp_rank=r, dp_size=2).batch_at(2)[0]
              for r in (0, 1)]
    np.testing.assert_array_equal(whole, np.concatenate(halves, 0))
    with pytest.raises(ValueError, match="seed"):
        SyntheticLMData(dataclasses.replace(cfg, seed=4)).load_state_dict(
            d1.state_dict())


def test_int8_roundtrip_and_error_feedback_match_reference():
    """Bit-equal quantization (the same fp32 scale, round half to even),
    an all-zero leaf kept at zero, and two error-feedback steps."""
    g = _np_tree(5, SHAPES)
    g["z"] = np.zeros((3,), np.float32)
    jg = {k: jnp.asarray(v) for k, v in g.items()}
    got = compression.int8_roundtrip(_torch(g))
    want = jcompression.int8_roundtrip(jg)
    for k in g:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    bound = {k: np.abs(v).max() / 254 + 1e-7 for k, v in g.items()}
    for k in g:
        assert np.abs(got[k].numpy() - g[k]).max() <= bound[k]
    res, jres = (compression.ErrorFeedback.init(_torch(g)),
                 jcompression.ErrorFeedback.init(jg))
    for step in range(2):
        g2 = _np_tree(50 + step, SHAPES)
        c, res = compression.ErrorFeedback.compress(_torch(g2), res)
        jc, jres = jcompression.ErrorFeedback.compress(
            {k: jnp.asarray(v) for k, v in g2.items()},
            {k: jres[k] for k in SHAPES})
        res = {k: res[k] for k in SHAPES}
        for k in SHAPES:
            np.testing.assert_array_equal(c[k].numpy(), np.asarray(jc[k]))
            np.testing.assert_array_equal(res[k].numpy(),
                                          np.asarray(jres[k]))


# ----------------------------------------------------------------------------
# Loss, gradients, train steps
# ----------------------------------------------------------------------------

@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    jcfg = jconfigs.get_smoke(request.param)
    cfg = configs.get_smoke(request.param)

    def bridge(tree):
        return params_from_jax(jax.tree.map(np.asarray, tree), cfg,
                               device="cpu", dtype=torch.float32)

    return jcfg, cfg, bridge


def _batch(cfg, step, batch=4, seq=16):
    tokens, labels = SyntheticLMData(DataConfig(
        vocab=cfg.vocab, seq_len=seq, global_batch=batch)).batch_at(step)
    return ({"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)},
            {"tokens": torch.from_numpy(tokens),
             "labels": torch.from_numpy(labels)})


def test_loss_and_gradients_match_reference(models):
    """``loss_fn`` and its autograd gradients through the plain ``sdpa``
    against ``jax.value_and_grad`` of the reference's ``loss_fn``."""
    jcfg, cfg, bridge = models
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
    jb, tb = _batch(cfg, 0)
    (jloss, jparts), jgrads = jax.value_and_grad(
        jsteps.loss_fn, has_aux=True)(jparams, jcfg, jb)
    tracked = tree_map(lambda p: p.requires_grad_(), bridge(jparams))
    loss, parts = steps.loss_fn(tracked, cfg, tb)
    assert float(parts["aux"]) == 0.0
    _close(loss.detach(), jloss, rtol=LOSS_TOL)
    _close(parts["nll"].detach(), jparts["nll"], rtol=LOSS_TOL)
    leaves = [p for _, p in tree_items(tracked)]
    grads = torch.autograd.grad(loss, leaves)
    want = dict(tree_items(bridge(jgrads)))
    assert len(grads) == len(want)
    for (key, w), g in zip(want.items(), grads):
        scale = float(w.abs().max())
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=LOSS_TOL,
                                   atol=LOSS_TOL * scale, err_msg=key)


@pytest.mark.parametrize("accum,compress,ef",
                         [(1, False, False), (2, False, False),
                          (1, True, False), (2, True, False),
                          (1, True, True)])
def test_three_train_steps_match_reference(models, accum, compress, ef):
    jcfg, cfg, bridge = models
    jstep = jax.jit(jsteps.make_train_step(
        jcfg, accum_steps=accum, compress_grads=compress,
        error_feedback=ef))
    jstate = jsteps.init_state(jax.random.PRNGKey(0), jcfg,
                               error_feedback=ef).tree()
    params = bridge(jstate["params"])
    state = steps.TrainState(
        params=params, opt=adamw.adamw_init(params),
        step=torch.zeros((), dtype=torch.int32),
        ef=compression.ErrorFeedback.init(params) if ef else None).tree()
    step = steps.make_train_step(cfg, accum_steps=accum,
                                 compress_grads=compress, error_feedback=ef)
    lr_max = 0.0
    for i in range(3):
        jb, tb = _batch(cfg, i)
        jstate, jm = jstep(jstate, jb)
        state, m = step(state, tb)
        assert abs(float(m["loss"]) - float(jm["loss"])) <= LOSS_TOL
        _close(m["lr"], jm["lr"])
        _close(m["grad_norm"], jm["grad_norm"], rtol=LOSS_TOL)
        lr_max = max(lr_max, float(m["lr"]))
    assert int(state["step"]) == 3 and int(state["opt"]["count"]) == 3
    want = dict(tree_items(bridge(jstate["params"])))
    for key, p in tree_items(state["params"]):
        diff = float((p - want[key]).abs().max())
        assert diff <= PARAM_ATOL_LR * lr_max, (key, diff)
    if ef:
        # A residual is at most half an int8 step of its leaf; an element
        # that rounds the other way differs by one step.
        want = dict(tree_items(bridge(jstate["ef"])))
        for key, r in tree_items(state["ef"]):
            step_size = 2 * float(want[key].abs().max())
            assert float((r - want[key]).abs().max()) <= 1.001 * step_size, \
                key


def test_train_step_never_runs_a_kernel_inside_the_gradient(models):
    """The kernels have no backward: a step of a model whose cache-less
    attention runs the kernel (``use_flash``) raises before it changes
    the state; a Mamba stack's step runs the plain chunked scan, never
    the scan kernel, and finishes."""
    _, cfg, _ = models
    state = steps.init_state(cfg, device="cpu").tree()
    before = {k: v.clone() for k, v in tree_items(state)}
    step = steps.make_train_step(dataclasses.replace(cfg, use_flash=True))
    with pytest.raises(RuntimeError, match="no backward"):
        step(state, _batch(cfg, 0)[1])
    for k, v in tree_items(state):
        assert torch.equal(v, before[k]), k
    mcfg = configs.get_smoke("mamba2-370m")
    mstate, metrics = steps.make_train_step(mcfg)(
        steps.init_state(mcfg, device="cpu").tree(), _batch(mcfg, 0)[1])
    assert int(mstate["step"]) == 1
    assert np.isfinite(float(metrics["loss"]))


# ----------------------------------------------------------------------------
# Checkpoints (mirrors of tests/test_checkpoint_trainer.py)
# ----------------------------------------------------------------------------

def _tree():
    return {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "nested": {"b": torch.ones(4, dtype=torch.bfloat16) * 1.5,
                       "l": [torch.zeros(2, dtype=torch.int32)]},
            "step": torch.tensor(7, dtype=torch.int32)}


def test_checkpoint_roundtrip_keeps_dtypes_and_layout(tmp_path):
    t = _tree()
    path = save_checkpoint(str(tmp_path), 7, t,
                           extra={"data": {"step": 7, "seed": 0}})
    assert os.path.basename(path) == "step-00000007"
    assert sorted(os.listdir(path)) == ["arrays.npz", "manifest.json"]
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["n_arrays"] == 4 and manifest["step"] == 7
    like = tree_map(torch.zeros_like, t)
    got, manifest = load_checkpoint(str(tmp_path), like)
    assert manifest["extra"]["data"] == {"step": 7, "seed": 0}
    for (k, a), (_, b) in zip(tree_items(got), tree_items(t)):
        assert a.dtype == b.dtype and torch.equal(a, b), k
    with pytest.raises(ValueError, match="nested/b"):
        load_checkpoint(str(tmp_path), dict(like, nested={
            "b": torch.zeros(4), "l": like["nested"]["l"]}))


def test_checkpoint_atomicity_no_partial_dirs(tmp_path):
    save_checkpoint(str(tmp_path), 1, _tree())
    save_checkpoint(str(tmp_path), 1, _tree())      # replaces in place
    assert os.listdir(tmp_path) == ["step-00000001"]
    assert latest_step(str(tmp_path)) == 1
    assert latest_step(str(tmp_path / "none")) is None


def test_manager_async_and_gc_snapshot_before_return(tmp_path):
    """Asynchronous saves keep the last ``keep``; each save holds the
    values at the time of the call, even when the caller updates the
    tensors in place right after it."""
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=True)
    t = _tree()
    for s in (1, 2, 3, 4):
        t["a"].fill_(s)
        mgr.save(s, t)
    t["a"].fill_(-1)
    mgr.wait()
    steps_on_disk = sorted(d for d in os.listdir(tmp_path)
                           if d.startswith("step-"))
    assert steps_on_disk == ["step-00000003", "step-00000004"]
    assert mgr.latest_step() == 4
    got, _ = mgr.restore(tree_map(torch.zeros_like, t), step=3)
    assert torch.equal(got["a"], torch.full((2, 3), 3.0))


# ----------------------------------------------------------------------------
# The trainer (mirrors of tests/test_checkpoint_trainer.py)
# ----------------------------------------------------------------------------

def _mk_trainer(path, fail_injector=None, steps_=20):
    cfg = configs.get_smoke("qwen3-4b")
    data = SyntheticLMData(DataConfig(vocab=cfg.vocab, seq_len=16,
                                      global_batch=2, seed=0))
    step = steps.make_train_step(cfg)
    init = lambda: steps.init_state(cfg, device="cpu").tree()  # noqa: E731
    return Trainer(
        TrainerConfig(checkpoint_dir=str(path), total_steps=steps_,
                      checkpoint_every=5, log_every=5,
                      async_checkpoint=False),
        cfg, data, step, init, device="cpu", fail_injector=fail_injector)


def test_trainer_loss_decreases(tmp_path):
    result = _mk_trainer(tmp_path / "a", steps_=30).run()
    losses = [m["loss"] for m in result["metrics"]]
    assert losses[-1] < losses[0]
    assert result["recoveries"] == 0


def test_trainer_recovers_from_preemption(tmp_path):
    fired = {"done": False}

    def injector(step):
        if step == 12 and not fired["done"]:
            fired["done"] = True
            raise SimulatedPreemption("node lost")

    tr = _mk_trainer(tmp_path / "b", fail_injector=injector, steps_=20)
    result = tr.run()
    assert result["recoveries"] == 1
    assert int(result["state"]["step"]) == 20
    assert tr.ckpt.latest_step() == 20


def test_trainer_restart_resumes_and_is_deterministic(tmp_path):
    d = tmp_path / "c"
    _mk_trainer(d, steps_=10).run()
    r2 = _mk_trainer(d, steps_=20).run()     # continues from step 10
    assert int(r2["state"]["step"]) == 20
    assert [m["step"] for m in r2["metrics"]] == [15, 20]
    r3 = _mk_trainer(tmp_path / "d", steps_=20).run()
    assert r2["metrics"][-1]["loss"] == pytest.approx(
        r3["metrics"][-1]["loss"], rel=1e-4)


class _StepClock:
    """Stands in for the trainer module's ``time``: ``perf_counter``
    advances one second a call, so every step measures the same time
    whatever else the machine runs (a wall-clock threshold moves when
    the tests run in parallel workers); ``advance`` makes a step
    slower."""

    def __init__(self):
        self.now = 0.0

    def perf_counter(self):
        self.now += 1.0
        return self.now

    def advance(self, seconds):
        self.now += seconds


def test_watchdog_flags_stragglers(tmp_path, monkeypatch):
    """Step 12 takes 10x the others: it, and only it, is flagged."""
    clock = _StepClock()
    monkeypatch.setattr(trainer_module, "time", clock)
    tr = _mk_trainer(tmp_path / "e", steps_=15)
    orig = tr.step_fn

    def slow_step(state, batch):
        if int(state["step"]) == 12:
            clock.advance(9.0)
        return orig(state, batch)

    tr.step_fn = slow_step
    assert tr.run()["stragglers"] == [12]


# ----------------------------------------------------------------------------
# The launcher
# ----------------------------------------------------------------------------

def test_launcher_trains_on_cpu_and_resumes(tmp_path, capsys, monkeypatch):
    """Loss falls over 30 steps; a second run to 40 resumes from step 30
    and ends where a fresh run to 40 does. The warmup spans all 40 steps,
    so the rate does not depend on ``--steps`` (the schedule's length).
    Every step takes the same time on the trainer's clock, so none is a
    straggler."""
    monkeypatch.setattr(trainer_module, "time", _StepClock())
    base = ["--arch", "qwen2-0.5b", "--smoke", "--device", "cpu", "--batch",
            "2", "--seq", "16", "--ckpt-every", "10", "--warmup", "40"]
    run = ["--ckpt", str(tmp_path / "run")]
    r1 = launch.main(base + run + ["--steps", "30"])
    out = capsys.readouterr().out
    assert "done: 3 logs, 0 recoveries, 0 stragglers" in out
    assert "step    30 loss=" in out
    losses = [m["loss"] for m in r1["metrics"]]
    assert losses[-1] < losses[0]
    r2 = launch.main(base + run + ["--steps", "40"])
    assert [m["step"] for m in r2["metrics"]] == [40]
    fresh = launch.main(base + ["--ckpt", str(tmp_path / "fresh"),
                                "--steps", "40"])
    assert r2["metrics"][-1]["loss"] == pytest.approx(
        fresh["metrics"][-1]["loss"], rel=1e-4)


@pytest.mark.parametrize("flags", [["--compress-grads"],
                                   ["--error-feedback", "--accum", "2"]])
def test_launcher_compressed_runs(tmp_path, flags):
    result = launch.main(["--arch", "qwen3-4b", "--smoke", "--device", "cpu",
                          "--batch", "2", "--seq", "8", "--steps", "4",
                          "--ckpt", str(tmp_path)] + flags)
    assert int(result["state"]["step"]) == 4
    assert ("ef" in result["state"]) == ("--error-feedback" in flags)


@pytest.mark.parametrize("flags,error", [
    (["--fsdp"], None),                        # without a mesh, a no-op
    (["--mesh", "single"], ValueError),        # 256 ranks, the group has 1
    (["--arch", "mamba2-370m"], None),         # trains now
    (["--use_flash=true"], RuntimeError),      # the kernel has no backward
    (["--use_flash=yes"], ValueError),
    (["--no_such_field=1"], ValueError),
    (["--pattern=attn"], ValueError),
    (["--stray"], SystemExit)])
def test_launcher_refuses_what_is_not_ported(tmp_path, flags, error):
    """Each flag the port lacks raises; ``error`` None is a case that was
    refused before and now runs to its end. ``--mesh single`` runs in a
    one-rank group and names the 256 ranks its mesh needs."""
    args = ["--arch", "qwen3-4b", "--smoke", "--device", "cpu", "--batch",
            "2", "--seq", "8", "--steps", "1", "--ckpt", str(tmp_path)]
    if error is None:
        result = launch.main(args + flags)
        assert int(result["state"]["step"]) == 1
        return
    if "--mesh" in flags:
        mesh_lib.init_group(0, 1, mesh_lib.free_port())
        try:
            with pytest.raises(error, match="needs 256 ranks"):
                launch.main(args + flags)
        finally:
            torch.distributed.destroy_process_group()
        return
    with pytest.raises(error):
        launch.main(args + flags)


@pytest.mark.parametrize("text,value", [("true", True), ("False", False),
                                        ("1", True), ("0", False)])
def test_overrides_parse_booleans_strictly(text, value):
    """The port's booleans parse strictly; the reference's
    ``apply_overrides`` turns every non-empty string into True
    (``bool("False")``)."""
    cfg = launch.apply_overrides(configs.get_smoke("qwen3-4b"),
                                 {"use_flash": text, "compute_dtype":
                                  "bfloat16", "d_ff": "48"})
    assert cfg.use_flash is value
    assert (cfg.compute_dtype, cfg.d_ff) == ("bfloat16", 48)
    jcfg = jlaunch.apply_overrides(jconfigs.get_smoke("qwen3-4b"),
                                   {"use_flash": text})
    assert jcfg.use_flash is True
