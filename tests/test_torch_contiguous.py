"""Contiguous-cache serving of the PyTorch port against the reference.

The port's ``ServingEngine(paged=False)`` and ``greedy_generate`` against
the reference's on the ``qwen3-4b`` and ``mamba2-370m`` smoke configs, on
the reference's weights carried across through numpy. The reference runs
its Pallas kernels in interpret mode (``use_flash=True`` for the decode
attention, ``use_ssd_kernel=True`` for the SSD scan), the port its
kernels' plain versions (CPU tensors). Greedy streams must be equal token
for token, and so must the ticks and the prefill buckets.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import transformer as JT
from repro.serve import engine as jengine

from repro_torch import configs
from repro_torch.bridge import params_from_jax
from repro_torch.kernels import ops
from repro_torch.models import transformer as T
from repro_torch.serve import engine

ARCHS = {"qwen3-4b": {"use_flash": True},
         "mamba2-370m": {"use_ssd_kernel": True}}
RUNS = {
    # name: (prompt lengths, batch, max_len, max_new)
    "roomy": ((5, 16, 17, 27, 9), 2, 64, 6),
    # slot 0's context runs past max_len: its later K/V rows are dropped
    # and its decode attends the max_len rows the cache holds.
    "past_end": ((20, 6), 2, 32, 20),
}
CASES = [("qwen3-4b", "roomy"), ("qwen3-4b", "past_end"),
         ("mamba2-370m", "roomy")]


@pytest.fixture(scope="module")
def models():
    """arch -> (reference config, reference params, config, params),
    built on first use."""
    built = {}

    def get(arch):
        if arch not in built:
            jcfg = dataclasses.replace(jconfigs.get_smoke(arch),
                                       **ARCHS[arch])
            jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
            cfg = configs.get_smoke(arch)
            params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                     device="cpu")
            built[arch] = (jcfg, jparams, cfg, params)
        return built[arch]

    return get


def _prompts(cfg, lengths):
    rng = np.random.RandomState(0)
    return [rng.randint(2, cfg.vocab, size=n).astype(np.int32)
            for n in lengths]


def _serve(eng, request_cls, prompts, max_new):
    for rid, p in enumerate(prompts):
        eng.submit(request_cls(rid=rid, prompt=p, max_new=max_new))
    return eng.run_until_drained()


@pytest.mark.parametrize("arch,run", CASES)
def test_streams_ticks_and_buckets_match_reference(models, arch, run):
    jcfg, jparams, cfg, params = models(arch)
    lengths, batch, max_len, max_new = RUNS[run]
    ref = jengine.ServingEngine(jparams, jcfg, jengine.ServeConfig(
        max_len=max_len, batch=batch, eos_id=-1))
    assert not ref.scfg.paged
    ref_streams = _serve(ref, jengine.Request, _prompts(cfg, lengths),
                         max_new)
    eng = engine.ServingEngine(params, cfg, engine.ServeConfig(
        max_len=max_len, batch=batch, eos_id=-1), device="cpu")
    assert eng.pool is None
    ops.reset_launches()
    streams = _serve(eng, engine.Request, _prompts(cfg, lengths), max_new)
    assert not any(ops.LAUNCHES.values())     # CPU tensors: plain path
    assert streams == ref_streams
    assert all(len(s) == max_new for s in streams.values())
    assert eng.ticks == ref.ticks
    assert set(eng.prefill_buckets) == set(ref.prefill_traces)
    assert sum(eng.prefill_buckets.values()) == len(lengths)
    if cfg.pattern == ("mamba",):       # SSM stacks prefill at exact length
        assert set(eng.prefill_buckets) == set(lengths)
    assert all(s is None for s in eng.slots)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_greedy_generate_matches_reference(models, arch):
    jcfg, jparams, cfg, params = models(arch)
    prompt = np.random.RandomState(3).randint(
        2, cfg.vocab, size=(2, 9)).astype(np.int32)
    want = np.asarray(jengine.greedy_generate(jparams, jcfg,
                                              jnp.asarray(prompt), 7))
    got = engine.greedy_generate(params, cfg, torch.from_numpy(prompt), 7)
    assert got.shape == (2, 7)
    np.testing.assert_array_equal(got.numpy(), want)


def test_contiguous_and_paged_engines_agree():
    """On the port alone: the two cache layouts serve the same greedy
    streams (a prompt longer than one chunk included)."""
    cfg = configs.get_smoke("qwen3-4b")
    params = T.init_params(cfg, torch.Generator().manual_seed(4),
                           device="cpu")
    prompts = _prompts(cfg, (5, 16, 17, 27))
    base = dict(max_len=64, batch=2, eos_id=-1)
    contiguous = _serve(engine.ServingEngine(
        params, cfg, engine.ServeConfig(**base), device="cpu"),
        engine.Request, prompts, 8)
    paged = _serve(engine.ServingEngine(
        params, cfg, engine.ServeConfig(paged=True, page_size=8,
                                        chunk_size=8, **base),
        device="cpu"), engine.Request, prompts, 8)
    assert contiguous == paged


def test_cache_lengths_follow_the_reference():
    cfg = configs.get_smoke("qwen3-4b")
    jcfg = jconfigs.get_smoke("qwen3-4b")
    for per_slot in (False, True):
        caches = T.init_caches(cfg, 3, 16, per_slot_index=per_slot,
                               device="cpu")
        jc = JT.init_caches(jcfg, 3, 16, per_slot_index=per_slot)
        assert caches[0]["index"].shape == jc[0]["index"].shape[1:]
        assert T.cache_lengths(caches).tolist() == \
            np.asarray(JT.cache_lengths(jc)).tolist()
        new = T.set_cache_lengths(caches, 5 if not per_slot else [1, 2, 3])
        jnew = JT.set_cache_lengths(jc, 5 if not per_slot else [1, 2, 3])
        assert T.cache_lengths(new).tolist() == \
            np.asarray(JT.cache_lengths(jnew)).tolist()
        assert all(c["k"] is n["k"] for c, n in zip(caches, new))


def test_engine_refuses_what_is_not_ported():
    cfg = configs.get_smoke("mamba2-370m")
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    with pytest.raises(ValueError, match="attention-only"):
        engine.ServingEngine(params, cfg, engine.ServeConfig(
            max_len=32, batch=2, paged=True, chunk_size=8, page_size=8),
            device="cpu")
    qcfg = configs.get_smoke("qwen3-4b")
    qparams = T.init_params(qcfg, torch.Generator().manual_seed(0),
                            device="cpu")
    with pytest.raises(ValueError, match="chunk_size"):
        engine.ServingEngine(qparams, qcfg, engine.ServeConfig(
            max_len=32, batch=2, paged=True, page_size=8, chunk_size=12),
            device="cpu")
    eng = engine.ServingEngine(qparams, qcfg, engine.ServeConfig(
        max_len=16, batch=2), device="cpu")
    eng.submit(engine.Request(rid=0, prompt=np.arange(2, 20, dtype=np.int32),
                              max_new=2))
    with pytest.raises(ValueError, match="max_len"):
        eng.tick()
