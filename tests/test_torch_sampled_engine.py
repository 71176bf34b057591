"""Sampled decoding of the PyTorch port's engines against the reference's.

At ``temperature`` 0.8 and ``seed`` 3 both engines draw every emitted
token under the threefry key of (request id, emitted index): the port's
paged and contiguous ``qwen3-4b`` smoke engines and its contiguous
``mamba2-370m`` smoke engine must give the reference engine's streams
(no near-tie flip is expected at these sizes), its scheduling decisions
(ticks, preemptions, holds) and its trace counters. Weights are the
reference's, carried across through numpy, in fp32; the reference runs
its Pallas kernels in interpret mode, the port its kernels' plain
versions (CPU tensors).
"""

import dataclasses

import jax
import numpy as np
import pytest

from repro import configs as jconfigs
from repro.models import transformer as JT
from repro.serve import engine as jengine

from repro_torch import configs
from repro_torch.bridge import params_from_jax
from repro_torch.serve import engine

ARCHS = {"qwen3-4b": {"use_flash": True},
         "mamba2-370m": {"use_ssd_kernel": True}}
PROMPT_LENS = (5, 16, 17, 27)
SAMPLED = dict(temperature=0.8, seed=3, eos_id=-1, max_len=64)
PAGED = dict(paged=True, page_size=8, chunk_size=8)
RUNS = {
    # name: (arch, ServeConfig fields, max_new)
    "paged": ("qwen3-4b", dict(batch=2, **PAGED), 10),
    "squeezed": ("qwen3-4b", dict(batch=3, n_pages=6, **PAGED), 10),
    "contiguous": ("qwen3-4b", dict(batch=2), 10),
    "mamba": ("mamba2-370m", dict(batch=2), 10),
}


@pytest.fixture(scope="module")
def models():
    built = {}

    def get(arch):
        if arch not in built:
            jcfg = dataclasses.replace(jconfigs.get_smoke(arch),
                                       **ARCHS[arch])
            jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
            cfg = configs.get_smoke(arch)
            params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                     device="cpu")
            rng = np.random.RandomState(0)
            prompts = [rng.randint(2, cfg.vocab, size=n).astype(np.int32)
                       for n in PROMPT_LENS]
            built[arch] = (jcfg, jparams, cfg, params, prompts)
        return built[arch]

    return get


def _serve(eng, request_cls, prompts, max_new):
    for rid, p in enumerate(prompts):
        eng.submit(request_cls(rid=rid, prompt=p, max_new=max_new))
    return eng.run_until_drained()


def _port(models, arch, **fields):
    _, _, cfg, params, prompts = models(arch)
    eng = engine.ServingEngine(params, cfg, engine.ServeConfig(**fields),
                               device="cpu")
    return eng, prompts


def _flips(a, b) -> int:
    return sum(x != y for r in a for x, y in zip(a[r], b[r]))


@pytest.mark.parametrize("run", sorted(RUNS))
def test_sampled_streams_and_decisions_match_reference(models, run):
    arch, fields, max_new = RUNS[run]
    jcfg, jparams, _, _, prompts = models(arch)
    ref = jengine.ServingEngine(jparams, jcfg, jengine.ServeConfig(
        **SAMPLED, **fields))
    want = _serve(ref, jengine.Request, prompts, max_new)
    eng, _ = _port(models, arch, **SAMPLED, **fields)
    got = _serve(eng, engine.Request, prompts, max_new)
    assert sorted(got) == sorted(want)
    assert _flips(got, want) == 0
    assert got == want
    assert all(len(s) == max_new for s in got.values())
    assert (eng.ticks, eng.preemptions, eng.admission_rejections) == \
        (ref.ticks, ref.preemptions, ref.admission_rejections)
    assert eng.decode_traces == ref.decode_traces == 1
    assert eng.prefill_traces == ref.prefill_traces
    if eng.pool is not None:
        assert eng.pool.pages_in_use == 0
    if run == "squeezed":
        assert eng.preemptions > 0 and eng.admission_rejections > 0
    # The sampler is in effect: the greedy engine serves other streams.
    greedy, _ = _port(models, arch, **dict(SAMPLED, temperature=0.0),
                      **fields)
    assert _flips(_serve(greedy, engine.Request, prompts, max_new), got) > 0


def test_preempted_streams_replay_their_keys(models):
    """Keys follow (request, emitted index), not ticks: a squeezed pool
    that preempts and re-admits serves the streams of a roomy pool."""
    arch, fields, max_new = RUNS["squeezed"]
    squeezed, prompts = _port(models, arch, **SAMPLED, **fields)
    roomy, _ = _port(models, arch, **SAMPLED,
                     **dict(fields, n_pages=None))
    got = _serve(squeezed, engine.Request, prompts, max_new)
    assert squeezed.preemptions > 0 and roomy.preemptions == 0
    assert got == _serve(roomy, engine.Request, prompts, max_new)


def test_seed_changes_the_streams(models):
    arch, fields, max_new = RUNS["contiguous"]
    a, prompts = _port(models, arch, **SAMPLED, **fields)
    b, _ = _port(models, arch, **dict(SAMPLED, seed=4), **fields)
    assert _flips(_serve(a, engine.Request, prompts, max_new),
                  _serve(b, engine.Request, prompts, max_new)) > 0
