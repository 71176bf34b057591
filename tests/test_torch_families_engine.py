"""The serving engines of the PyTorch port against the reference's on the
new model families: greedy streams of the paged engine on the dbrx-132b
and llama4-maverick smoke configs, and of the contiguous engine on the
jamba-v0.1 smoke config, at ``moe_impl`` ``dense_mask`` and
``capacity``, token for token, with the same ticks.

The weights are the reference's ``init_params`` carried across through
numpy; prompts are numpy arrays from a seed. The reference runs its
Pallas kernels in interpret mode (``use_flash``, ``use_ssd_kernel``), the
port its kernels' plain versions (CPU tensors).
"""

import dataclasses

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
from repro_torch.serve import engine

KERNEL_FLAGS = {"use_flash": True, "use_ssd_kernel": True}


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread for these smoke-size tensors: the suite's
    parallel workers would otherwise oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    """arch -> (reference params, port params), built on first use."""
    built = {}

    def get(arch):
        if arch not in built:
            jcfg = dataclasses.replace(jconfigs.get_smoke(arch),
                                       **KERNEL_FLAGS)
            jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
            built[arch] = (jparams, params_from_jax(
                jax.tree.map(np.asarray, jparams), configs.get_smoke(arch),
                device="cpu"))
        return built[arch]

    return get


# Engine runs: (arch, paged, prompt lengths), 6 new tokens each, batch 2;
# paged: pages of 8, chunks of 8, max_len 64. Jamba prefills at exact
# length (the reference traces one prefill a length): two lengths.
ENGINE_CASES = [("dbrx-132b", True, (5, 16, 27, 9)),
                ("llama4-maverick-400b-a17b", True, (5, 16, 27, 9)),
                ("jamba-v0.1-52b", False, (5, 12, 5))]
MAX_NEW = 6


def _serve(eng, request_cls, prompts):
    for rid, p in enumerate(prompts):
        eng.submit(request_cls(rid=rid, prompt=p, max_new=MAX_NEW))
    return eng.run_until_drained()


@pytest.mark.parametrize("impl", ["dense_mask", "capacity"])
@pytest.mark.parametrize("arch,paged,lengths", ENGINE_CASES)
def test_engine_streams_match_reference(weights, arch, paged, lengths, impl):
    """Greedy streams and ticks of the port's engine against the
    reference's on the same weights. At ``capacity`` the experts' buffers
    are sized by each step's (b, s): the decode step's batch, the paged
    chunk's width, the contiguous prefill's exact length; equal streams
    say the port's steps size them alike."""
    jparams, params = weights(arch)
    jcfg = dataclasses.replace(jconfigs.get_smoke(arch), moe_impl=impl,
                               **KERNEL_FLAGS)
    cfg = dataclasses.replace(configs.get_smoke(arch), moe_impl=impl)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(2, cfg.vocab, size=n).astype(np.int32)
               for n in lengths]
    kw = dict(max_len=64, batch=2, eos_id=-1)
    if paged:
        kw.update(paged=True, page_size=8, chunk_size=8)
    ref = jengine.ServingEngine(jparams, jcfg, jengine.ServeConfig(**kw))
    want = _serve(ref, jengine.Request, prompts)
    eng = engine.ServingEngine(params, cfg, engine.ServeConfig(**kw),
                               device="cpu")
    ops.reset_launches()
    got = _serve(eng, engine.Request, prompts)
    assert got == want
    assert all(len(s) == MAX_NEW for s in got.values())
    assert eng.ticks == ref.ticks
    assert sum(ops.LAUNCHES.values()) == 0        # CPU tensors: plain path
