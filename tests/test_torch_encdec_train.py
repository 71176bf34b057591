"""Training the encoder-decoder and cross-attention families in the
PyTorch port against the reference: one ``make_train_step`` step of the
whisper-medium and llama-3.2-vision-90b smokes, each batch with a
frontend, and the training launcher's frontend stub.

whisper-medium's encoder feeds no layer (its pattern has no cross
layer), so ``jax.value_and_grad`` gives its parameters zero gradients and
AdamW's weight decay alone moves them; the port must do the same, not
skip them. The parameters that start at zero (the gate, biases,
LayerNorm's bias) are set to seeded non-zero values first, as in
``tests/test_torch_encdec.py``.

Tolerances are ``tests/test_torch_train.py``'s: losses within 1e-4,
parameters after a step within a tenth of its learning rate (at step 1
AdamW's m_hat / sqrt(v_hat) is the sign of the gradient, so an element
whose gradient is near zero may move by a fraction of lr differently in
the two frameworks). The encoder's leaves, moved by weight decay alone,
are held to 1e-6 relative.
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
from repro_torch.dist import compression
from repro_torch.launch import train as launch
from repro_torch.optim import adamw
from repro_torch.train import steps
from repro_torch.tree import tree_items

ARCHS = ["whisper-medium", "llama-3.2-vision-90b"]
LOSS_TOL = 1e-4
PARAM_ATOL_LR = 0.1
DECAY_RTOL = 1e-6
ZERO_AT_INIT = ("bias", "b_q", "b_k", "b_v", "b_up")


def nonzero_init(tree, seed=1):
    """The reference's parameters as numpy, the gate set to 0.5 plus
    noise and biases to 0.1 times a standard normal (as
    ``tests/test_torch_encdec.py`` sets them)."""
    rng = np.random.RandomState(seed)

    def leaf(path, a):
        name, a = getattr(path[-1], "key", None), np.array(a)
        if name == "gate":
            return np.asarray(0.5 + 0.1 * rng.randn(*a.shape), np.float32)
        if name in ZERO_AT_INIT:
            return np.asarray(0.1 * rng.randn(*a.shape), np.float32)
        return a

    return jax.tree_util.tree_map_with_path(leaf, tree)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(cfg, step, batch=4, seq=16):
    tokens, labels = SyntheticLMData(DataConfig(
        vocab=cfg.vocab, seq_len=seq, global_batch=batch)).batch_at(step)
    frontend = np.random.RandomState(step).randn(
        batch, cfg.n_frontend_tokens, cfg.d_model).astype(np.float32)
    return ({"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels),
             "frontend": jnp.asarray(frontend)},
            {"tokens": torch.from_numpy(tokens),
             "labels": torch.from_numpy(labels),
             "frontend": torch.from_numpy(frontend)})


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("accum,compress,ef", [(1, False, False),
                                               (2, True, True)])
def test_train_step_matches_reference(arch, accum, compress, ef):
    """Loss, nll, and every parameter after one step (int8 compression
    with error feedback: one scale a leaf stacked over its pattern
    position's periods, the encoder's over its layers, as the
    reference's). whisper's encoder leaves got a zero gradient and moved
    by weight decay alone, in both packages."""
    jcfg, cfg = jconfigs.get_smoke(arch), configs.get_smoke(arch)
    jstate = jsteps.init_state(jax.random.PRNGKey(0), jcfg,
                               error_feedback=ef).tree()
    np_params = nonzero_init(jstate["params"])
    jstate["params"] = jax.tree.map(jnp.asarray, np_params)
    params = params_from_jax(np_params, cfg, device="cpu",
                             dtype=torch.float32)
    before = {k: v.clone() for k, v in tree_items(params)}
    state = steps.TrainState(
        params=params, opt=adamw.adamw_init(params),
        step=torch.zeros((), dtype=torch.int32),
        ef=compression.ErrorFeedback.init(params) if ef else None).tree()
    jstep = jax.jit(jsteps.make_train_step(
        jcfg, accum_steps=accum, compress_grads=compress, error_feedback=ef))
    step = steps.make_train_step(cfg, accum_steps=accum,
                                 compress_grads=compress, error_feedback=ef)
    jb, tb = _batch(cfg, 0)
    jstate, jm = jstep(jstate, jb)
    state, m = step(state, tb)
    for k in ("loss", "nll"):
        assert abs(float(m[k]) - float(jm[k])) <= LOSS_TOL, k
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               rtol=LOSS_TOL)
    lr = float(m["lr"])
    want = dict(tree_items(params_from_jax(
        jax.tree.map(np.asarray, jstate["params"]), cfg, device="cpu",
        dtype=torch.float32)))
    assert want.keys() == dict(tree_items(state["params"])).keys()
    for key, p in tree_items(state["params"]):
        diff = float((p - want[key]).abs().max())
        assert diff <= PARAM_ATOL_LR * lr, (key, diff)
        if key.startswith("encoder/"):
            decayed = before[key] * (1 - lr * adamw.AdamWConfig().weight_decay)
            np.testing.assert_allclose(p.numpy(), decayed.numpy(),
                                       rtol=DECAY_RTOL, err_msg=key)
            np.testing.assert_allclose(want[key].numpy(), decayed.numpy(),
                                       rtol=DECAY_RTOL, err_msg=key)
    assert any(k.startswith("encoder/") for k in want) == (arch ==
                                                           "whisper-medium")


def test_untouched_parameters_get_zero_gradients():
    """whisper's encoder leaves get zero gradients (not None, not
    skipped), so the optimizer's moments stay zero for them; the
    decoder's gradients are not zero."""
    cfg = configs.get_smoke("whisper-medium")
    state = steps.init_state(cfg, device="cpu").tree()
    step = steps.make_train_step(cfg)
    state, m = step(state, _batch(cfg, 0)[1])
    for key, mom in tree_items(state["opt"]["m"]):
        zero = not mom.any()
        assert zero == key.startswith("encoder/"), key
    assert np.isfinite(float(m["loss"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_trains_with_the_frontend_stub(arch, tmp_path):
    """``launch/train.py`` feeds zeros of (batch, n_frontend_tokens,
    d_model) as the frontend, as the reference's ``frontend_stub``; every
    step is logged with ``--log-every 1`` and its loss is finite."""
    cfg = configs.get_smoke(arch)
    make = launch.frontend_stub(cfg, "cpu")
    fe = make(3)
    assert fe.shape == (3, cfg.n_frontend_tokens, cfg.d_model)
    assert fe.dtype == cfg.dtype and not fe.any()
    assert launch.frontend_stub(configs.get_smoke("qwen3-4b"), "cpu") is None
    result = launch.main(["--arch", arch, "--smoke", "--device", "cpu",
                          "--batch", "2", "--seq", "16", "--steps", "4",
                          "--log-every", "1", "--warmup", "4",
                          "--ckpt", str(tmp_path)])
    losses = [m["loss"] for m in result["metrics"]]
    assert [m["step"] for m in result["metrics"]] == [1, 2, 3, 4]
    assert all(np.isfinite(losses))


def test_launcher_names_the_distribution_item(tmp_path):
    """``--fsdp`` no longer raises: without a mesh it does nothing, as in
    the reference, so whisper trains on one rank (over a model axis its
    encoder splits by heads: ``tests/test_torch_model_axis_families.py``)."""
    result = launch.main(["--arch", "whisper-medium", "--smoke", "--device",
                          "cpu", "--fsdp", "--batch", "2", "--seq", "8",
                          "--steps", "1", "--ckpt", str(tmp_path)])
    assert int(result["state"]["step"]) == 1
    assert np.isfinite(result["metrics"][-1]["loss"])


def test_moe_and_mamba_patterns_still_refuse_to_train():
    """Every pattern trains now: the vision pattern, a Mamba stack (the
    jamba hybrid without its experts) and a mixture of experts each take
    a step to a finite loss (``tests/test_torch_train_families.py``
    holds their gradients to the reference's)."""
    for cfg in (configs.get_smoke("llama-3.2-vision-90b"),
                dataclasses.replace(configs.get_smoke("jamba-v0.1-52b"),
                                    n_experts=0, moe_positions=()),
                configs.get_smoke("dbrx-132b")):
        tokens, labels = SyntheticLMData(DataConfig(
            vocab=cfg.vocab, seq_len=8, global_batch=2)).batch_at(0)
        batch = {"tokens": torch.from_numpy(tokens),
                 "labels": torch.from_numpy(labels)}
        if cfg.n_frontend_tokens:
            batch["frontend"] = launch.frontend_stub(cfg, "cpu")(2)
        state, metrics = steps.make_train_step(cfg)(
            steps.init_state(cfg, device="cpu").tree(), batch)
        assert int(state["step"]) == 1, cfg.name
        assert np.isfinite(float(metrics["loss"])), cfg.name
        assert (float(metrics["aux"]) > 0) == bool(cfg.n_experts), cfg.name
