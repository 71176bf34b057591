"""Remat in the PyTorch port: each period checkpointed
(``ModelConfig.remat``, ``T.forward_aux``) with the "full" and the "dots"
policy gives the loss and gradients of remat off, on one device and on a
(data 1, model 2) mesh of gloo CPU ranks (rank functions in
``tests/_torch_mesh_workers.py``; the recompute runs the period's
collectives again), and those of the reference's ``remat=True``
``loss_fn`` under ``jax.value_and_grad``.

Cases: qwen3-4b smoke (attention and MLP split by heads and ``mlp``) and
jamba smoke (Mamba mixers split by SSM heads, mixtures by experts, one
attention layer).

Tolerances: remat against remat off within 1e-6 of each leaf's largest
element (the same ops in the same order; the recompute gives the same
bits); against the reference within 1e-4, the tolerance of
``tests/test_torch_train.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.train import steps as jsteps
from repro.models import transformer as JT

from repro_torch import configs
from repro_torch.bridge import params_from_jax
from repro_torch.data import DataConfig, SyntheticLMData
from repro_torch.launch import mesh as mesh_lib
from repro_torch.train import steps
from repro_torch.tree import tree_items

import _torch_mesh_workers as workers

TOL = 1e-6
REF_TOL = 1e-4
ARCHS = {"qwen3": "qwen3-4b", "jamba": "jamba-v0.1-52b"}
REMATS = {"off": {}, "full": {"remat": True},
          "dots": {"remat": True, "remat_policy": "dots"}}


@pytest.fixture(scope="module")
def inputs():
    params, batch, want = {}, {}, {}
    for key, arch in ARCHS.items():
        jcfg = jconfigs.get_smoke(arch)
        params[key] = jax.tree.map(
            np.asarray, JT.init_params(jax.random.PRNGKey(0), jcfg))
        tokens, labels = SyntheticLMData(DataConfig(
            vocab=jcfg.vocab, seq_len=16, global_batch=4)).batch_at(0)
        batch[key] = {"tokens": tokens, "labels": labels}
        jr = dataclasses.replace(jcfg, remat=True)
        (loss, _), grads = jax.jit(jax.value_and_grad(
            lambda p, b: jsteps.loss_fn(p, jr, b), has_aux=True))(
            jax.tree.map(jnp.asarray, params[key]),
            {k: jnp.asarray(v) for k, v in batch[key].items()})
        cfg = configs.get_smoke(arch)
        want[key] = (float(loss), {k: v.numpy() for k, v in tree_items(
            params_from_jax(jax.tree.map(np.asarray, grads), cfg,
                            device="cpu", dtype=torch.float32))})
    return params, batch, want


def _one(params, cfg, batch):
    full = params_from_jax(params, cfg, device="cpu", dtype=torch.float32)
    loss, _, grads, _ = steps.make_grad_fn(cfg)(
        full, {k: torch.from_numpy(v) for k, v in batch.items()})
    return float(loss), {k: v.numpy() for k, v in tree_items(grads)}


def _close(got, want, tol):
    for k, w in want.items():
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(got[k] - w).max())
        assert err <= tol * scale, (k, err, scale)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_remat_equals_no_remat_on_one_device(inputs, arch):
    params, batch, want = inputs
    base = configs.get_smoke(ARCHS[arch])
    off = _one(params[arch], base, batch[arch])
    for name in ("full", "dots"):
        cfg = dataclasses.replace(base, **REMATS[name])
        loss, grads = _one(params[arch], cfg, batch[arch])
        assert loss == pytest.approx(off[0], rel=TOL, abs=0.0)
        _close(grads, off[1], TOL)
        assert loss == pytest.approx(want[arch][0], rel=REF_TOL)
        _close(grads, want[arch][1], REF_TOL)


def test_remat_equals_no_remat_over_a_model_axis(inputs):
    params, batch, want = inputs
    cases = [dict(arch=ARCHS[a], arch_key=a, shape=(1, 2),
                  fields=REMATS[r]) for a in ARCHS for r in REMATS]
    ranks = mesh_lib.run_ranks(workers.remat_group, 2,
                               args=(cases, params, batch),
                               deadline_s=120.0)
    for rank in ranks:
        by = {(c["arch_key"], r): got for c, got, r in
              zip(cases, rank, [r for _ in ARCHS for r in REMATS])}
        for a in ARCHS:
            off = by[(a, "off")]
            for r in ("full", "dots"):
                assert by[(a, r)]["loss"] == pytest.approx(
                    off["loss"], rel=TOL, abs=0.0)
                _close(by[(a, r)]["grads"], off["grads"], TOL)
            assert off["loss"] == pytest.approx(want[a][0], rel=REF_TOL)
