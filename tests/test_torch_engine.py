"""Paged serving engine of the PyTorch port against the reference engine.

Both engines serve the same prompts on the same weights (the reference's
``init_params``, carried across through numpy) on the ``qwen3-4b`` smoke
config; the reference runs with ``use_flash=True``, i.e. its Pallas kernels
in interpret mode, the port its kernels' plain versions (CPU tensors).
Greedy streams must be equal token for token, and so must the scheduling
decisions: preemptions and admission holds. Each reference engine runs
once per module.
"""

import dataclasses
import gc
import weakref

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import transformer as JT
from repro.serve import engine as jengine

from repro_torch import configs
from repro_torch.bridge import params_from_jax
from repro_torch.kernels import ops
from repro_torch.serve import engine, paged

PROMPT_LENS = (5, 16, 17, 27)
BASE = dict(max_len=64, page_size=8, chunk_size=8, eos_id=-1, paged=True)
RUNS = {
    # name: (batch, n_pages, max_new)
    "roomy": (2, None, 8),
    "squeezed": (3, 6, 10),
}


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(jconfigs.get_smoke("qwen3-4b"), use_flash=True)
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
    cfg = configs.get_smoke("qwen3-4b")
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                             device="cpu")
    rng = np.random.RandomState(0)
    prompts = [rng.randint(2, cfg.vocab, size=n).astype(np.int32)
               for n in PROMPT_LENS]
    return jcfg, jparams, cfg, params, prompts


def _serve(eng, request_cls, prompts, max_new):
    for rid, p in enumerate(prompts):
        eng.submit(request_cls(rid=rid, prompt=p, max_new=max_new))
    return eng.run_until_drained()


@pytest.fixture(scope="module")
def reference_runs(model):
    jcfg, jparams, _, _, prompts = model
    out = {}
    for name, (batch, n_pages, max_new) in RUNS.items():
        eng = jengine.ServingEngine(jparams, jcfg, jengine.ServeConfig(
            batch=batch, n_pages=n_pages, **BASE))
        streams = _serve(eng, jengine.Request, prompts, max_new)
        out[name] = (eng, streams)
    return out


def _port_engine(model, batch, n_pages):
    _, _, cfg, params, _ = model
    return engine.ServingEngine(params, cfg, engine.ServeConfig(
        batch=batch, n_pages=n_pages, **BASE), device="cpu")


@pytest.mark.parametrize("run", sorted(RUNS))
def test_streams_and_decisions_match_reference(model, reference_runs, run):
    batch, n_pages, max_new = RUNS[run]
    ref, ref_streams = reference_runs[run]
    eng = _port_engine(model, batch, n_pages)
    ops.reset_launches()
    streams = _serve(eng, engine.Request, model[4], max_new)
    assert streams == ref_streams
    assert all(len(s) == max_new for s in streams.values())
    assert eng.preemptions == ref.preemptions
    assert eng.admission_rejections == ref.admission_rejections
    assert eng.ticks == ref.ticks
    assert eng.pool.pages_in_use == 0
    assert eng.pool.pages_allocated == ref.pool.pages_allocated
    assert sum(ops.LAUNCHES.values()) == 0      # CPU tensors: plain path
    if run == "squeezed":
        assert eng.preemptions > 0 and eng.admission_rejections > 0


def test_decode_advances_while_a_long_prompt_prefills(model):
    eng = _port_engine(model, 2, None)
    _, _, _, _, prompts = model
    short = engine.Request(rid=0, prompt=prompts[0], max_new=8)
    eng.submit(short)
    eng.submit(engine.Request(rid=1, prompt=prompts[3], max_new=8))
    overlapped = 0
    while eng.queue or any(s is not None for s in eng.slots):
        before = len(short.generated)
        eng.tick()
        if 1 in eng._prefilling and len(short.generated) > before:
            overlapped += 1
    # 27 rows in chunks of 8: three ticks mid-prefill, each decoding slot 0.
    assert overlapped == 3
    assert eng.chunk_steps == 1 + 4
    assert eng.pool.pages_in_use == 0


def test_never_admittable_request_and_sampling_raise(model):
    """A request that could not fit even an empty pool raises at
    admission, greedy or sampled (sampling itself no longer raises:
    ``tests/test_torch_sampled_engine.py`` holds it to the reference)."""
    _, _, cfg, params, prompts = model
    for temperature in (0.0, 0.7):
        eng = engine.ServingEngine(params, cfg, engine.ServeConfig(
            batch=2, n_pages=3, temperature=temperature, **BASE),
            device="cpu")                      # capacity: 2 pages
        eng.submit(engine.Request(rid=0, prompt=prompts[3], max_new=4))
        with pytest.raises(paged.PagePoolExhausted):
            eng.tick()


def test_pool_rows_of_live_pages_follow_the_page_table(model):
    """After the first chunk, the slot's rows sit in the pages its table
    names, and the decode step's garbage write at the cursor has been
    undone: the write position is back at the chunk's end."""
    eng = _port_engine(model, 2, None)
    _, _, _, _, prompts = model
    eng.submit(engine.Request(rid=0, prompt=prompts[1], max_new=4))
    eng.tick()
    pages = eng.pool.slot_pages[0]
    assert list(eng.pages[0, :len(pages)]) == pages
    kp = eng.caches[0]["kp"]
    assert torch.count_nonzero(kp[pages]) > 0
    assert eng._prefilling[0] == eng.index[0] == 8


@pytest.mark.parametrize("paged", [True, False])
def test_engine_is_freed_as_soon_as_it_is_dropped(model, paged):
    """No reference cycle holds an engine (and its caches, gigabytes on
    the card) until the garbage collector runs: its steps close over
    their buffers, not over the engine."""
    _, _, cfg, params, prompts = model
    eng = engine.ServingEngine(params, cfg, engine.ServeConfig(
        batch=2, **dict(BASE, paged=paged)), device="cpu")
    eng.submit(engine.Request(rid=0, prompt=prompts[0], max_new=3))
    eng.run_until_drained()
    alive = weakref.ref(eng)
    gc.disable()
    try:
        del eng
        assert alive() is None
    finally:
        gc.enable()
