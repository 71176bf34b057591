"""Training every family in the PyTorch port against the reference: the
mixtures of experts (dbrx-132b, llama4-maverick with its shared expert,
the jamba-v0.1 hybrid) at both ``moe_impl``s and the Mamba-2 stack
(mamba2-370m), whose Mamba layers train through the plain chunked scan
in fp32 (``forward_aux(..., ssd_kernel=False)``), as the reference's
default ``use_ssd_kernel=False`` does.

The loss, its ``nll`` and ``aux`` parts and every leaf's gradient are
held to ``jax.value_and_grad`` of ``repro/train/steps.py:loss_fn`` on
the same numpy inputs at rtol 1e-4 (each leaf's atol 1e-4 of its largest
element: two frameworks' sums in another order through a few layers, as
``tests/test_torch_train.py`` states), except the jamba hybrid's
gradients at 2e-4: through its eight layers of Mamba, attention and
experts the fp32 gradient is ill-conditioned, and the two frameworks'
gradients differ by up to 1.4e-4 of a leaf's largest element
(``blocks/0/mlp/w_gate``, capacity routing) where every other case
stays under 1e-4. A step of the launcher trains
the jamba smoke and resumes from its checkpoint.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.train import steps as jsteps

from repro_torch import configs
from repro_torch.bridge import params_from_jax
from repro_torch.data import DataConfig, SyntheticLMData
from repro_torch.launch import train as launch
from repro_torch.models import transformer as T
from repro_torch.train import steps
from repro_torch.tree import tree_items, tree_map

LOSS_TOL = 1e-4
GRAD_TOL = {"jamba-v0.1-52b": 2e-4}
MOE_ARCHS = ["dbrx-132b", "llama4-maverick-400b-a17b", "jamba-v0.1-52b"]
CASES = ([(a, impl) for a in MOE_ARCHS for impl in ("capacity", "dense_mask")]
         + [("mamba2-370m", None)])


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, impl):
    jcfg, cfg = jconfigs.get_smoke(arch), configs.get_smoke(arch)
    if impl is not None:
        jcfg = dataclasses.replace(jcfg, moe_impl=impl)
        cfg = dataclasses.replace(cfg, moe_impl=impl)
    return jcfg, cfg


def _batch(cfg, step=0, batch=2, seq=16):
    tokens, labels = SyntheticLMData(DataConfig(
        vocab=cfg.vocab, seq_len=seq, global_batch=batch)).batch_at(step)
    return ({"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)},
            {"tokens": torch.from_numpy(tokens),
             "labels": torch.from_numpy(labels)})


@pytest.mark.parametrize("arch,impl", CASES)
def test_loss_parts_and_gradients_match_reference(arch, impl):
    jcfg, cfg = _cfgs(arch, impl)
    jparams = jax.tree.map(np.asarray, jsteps.init_state(
        jax.random.PRNGKey(0), jcfg).params)
    jb, tb = _batch(cfg)
    (jloss, jparts), jgrads = jax.value_and_grad(
        jsteps.loss_fn, has_aux=True)(jparams, jcfg, jb)
    tracked = tree_map(lambda p: p.requires_grad_(), params_from_jax(
        jparams, cfg, device="cpu", dtype=torch.float32))
    loss, parts = steps.loss_fn(tracked, cfg, tb)
    for got, want in ((loss, jloss), (parts["nll"], jparts["nll"]),
                      (parts["aux"], jparts["aux"])):
        np.testing.assert_allclose(float(got.detach()), float(want),
                                   rtol=LOSS_TOL)
    if cfg.n_experts:
        assert float(parts["aux"]) > 0.0
    else:
        assert float(parts["aux"]) == 0.0
    leaves = [p for _, p in tree_items(tracked)]
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    want = dict(tree_items(params_from_jax(
        jax.tree.map(np.asarray, jgrads), cfg, device="cpu",
        dtype=torch.float32)))
    assert len(grads) == len(want)
    tol = GRAD_TOL.get(arch, LOSS_TOL)
    for (key, w), g in zip(want.items(), grads):
        g = torch.zeros_like(w) if g is None else g
        scale = float(w.abs().max())
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=tol,
                                   atol=tol * scale, err_msg=key)


def test_mamba_training_never_reaches_the_scan_kernel(monkeypatch):
    """The training step's forward asks for the plain chunked scan: the
    kernel's wrapper is never called, while serving's forward calls it."""
    from repro_torch.kernels import ops

    cfg = configs.get_smoke("mamba2-370m")
    calls = []
    real = ops.ssd_scan
    monkeypatch.setattr(ops, "ssd_scan",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    state = steps.init_state(cfg, device="cpu").tree()
    _, tb = _batch(cfg)
    _, metrics = steps.make_train_step(cfg)(state, tb)
    assert calls == [] and np.isfinite(float(metrics["loss"]))
    T.forward(state["params"], cfg, tb["tokens"])
    assert calls


@pytest.mark.parametrize("arch", ["dbrx-132b", "mamba2-370m"])
def test_accumulated_step_matches_one_batch(arch):
    """Two micro-batches average to the whole batch's loss (the
    accumulated path reports ``nll`` = the loss and ``aux`` 0, as the
    reference's does)."""
    cfg = configs.get_smoke(arch)
    _, tb = _batch(cfg, batch=4)
    one = steps.make_train_step(cfg)(steps.init_state(cfg, device="cpu")
                                     .tree(), tb)[1]
    two = steps.make_train_step(cfg, accum_steps=2)(
        steps.init_state(cfg, device="cpu").tree(), tb)[1]
    assert float(two["aux"]) == 0.0
    assert float(two["nll"]) == float(two["loss"])
    if not cfg.n_experts:
        np.testing.assert_allclose(float(two["loss"]), float(one["loss"]),
                                   rtol=1e-5)


def test_launcher_trains_jamba_and_resumes(tmp_path):
    base = ["--arch", "jamba-v0.1-52b", "--smoke", "--device", "cpu",
            "--batch", "2", "--seq", "16", "--log-every", "1", "--ckpt",
            str(tmp_path)]
    first = launch.main(base + ["--steps", "3"])
    assert [m["step"] for m in first["metrics"]] == [1, 2, 3]
    assert all(np.isfinite(m["loss"]) and m["aux"] > 0
               for m in first["metrics"])
    again = launch.main(base + ["--steps", "5"])
    assert [m["step"] for m in again["metrics"]] == [4, 5]


def test_mamba_gradients_follow_a_float64_input():
    """At ``compute_dtype`` float64 the Mamba path's fp32 islands (the
    chunked scan, the norms, the loss: ``layers.wide``) run in float64,
    so the mamba2-370m stack's gradients are well conditioned: one and
    four threads agree to 1e-12 of each leaf's largest element, where
    fp32 spreads by orders of magnitude more. fp32 and bf16 inputs keep
    fp32 (``wide``), so no fp32 result moves."""
    from repro_torch.models import layers

    assert layers.wide(torch.float32) == torch.float32
    assert layers.wide(torch.bfloat16) == torch.float32
    assert layers.wide(torch.float64) == torch.float64
    cfg = dataclasses.replace(configs.get_smoke("mamba2-370m"),
                              compute_dtype="float64")
    # float64 masters too, so that no gradient is rounded to fp32.
    params = tree_map(lambda p: p.double(),
                      steps.init_state(cfg, 0, "cpu").params)
    tokens, labels = SyntheticLMData(DataConfig(
        vocab=cfg.vocab, seq_len=32, global_batch=2)).batch_at(0)
    batch = {"tokens": torch.from_numpy(tokens),
             "labels": torch.from_numpy(labels)}

    def grads(threads):
        torch.set_num_threads(threads)
        tracked = tree_map(lambda p: p.detach().requires_grad_(), params)
        leaves = [p for _, p in tree_items(tracked)]
        logits, _, _ = T.forward_aux(tracked, cfg, batch["tokens"],
                                     ssd_kernel=False)
        assert logits.dtype == torch.float64
        loss, parts = steps.loss_fn(tracked, cfg, batch)
        assert parts["nll"].dtype == torch.float64
        return torch.autograd.grad(loss, leaves)

    one, four = grads(1), grads(4)
    for a, b in zip(one, four):
        scale = max(float(b.abs().max()), 1e-30)
        assert float((a - b).abs().max()) <= 1e-12 * scale + 1e-30
