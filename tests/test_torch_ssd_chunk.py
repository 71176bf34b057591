"""The SSD scan's ``chunk`` argument on the CPU: ``ops.ssd_scan(chunk=)``
at each chunk the CUDA kernel instantiates against the reference's Pallas
scan (interpret mode) and its ``ops.ssd_scan`` at the same chunk, the
snapping of a given chunk to an instantiated one, ``mamba_apply`` passing
``MambaConfig.chunk`` on the mamba2-370m smoke, and the launch grid at
each chunk.

Tolerance: ``ref.TOLERANCE`` (fp32: 1e-4) scaled by the output's
magnitude (``ref.compare(normwise=True)``): the two sides run the same
chunked scan at the same chunk in fp32 and differ only in the order of
their sums. ``mamba_apply`` is held at 2e-4 absolute plus relative, the
reference's own tolerance for its chunked scan against its sequential
one (``tests/test_moe_mamba.py``; ``test_torch_mamba.py``'s
``CHUNKS_DIFFER``): both sides scan at chunk 64, but each decay
exp(a_cum[i] - a_cum[j]) is a difference of cumulative sums over up to 64
rows that the two sum in another order (measured: 2.5e-5 at |y| near 2).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.kernels import ops as jops
from repro.kernels import ssd_scan as jssd
from repro.models import mamba as jmamba
from repro.models import transformer as JT

from repro_torch import configs
from repro_torch.bridge import params_from_jax
from repro_torch.core import op_analysis
from repro_torch.kernels import cost, ops, ref
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.models import mamba

MAMBA_TOL = 2e-4


def _inputs(seed, bt, l, h, p, n):
    """The model's decays (dt * A, A from 1 to 16), as
    ``test_torch_ssd.py`` draws them."""
    rng = np.random.RandomState(seed)
    x = rng.randn(bt, l, h, p).astype(np.float32)
    dt = np.log1p(np.exp(rng.randn(bt, l, h))).astype(np.float32)
    a = (-dt * np.linspace(1, 16, h)).astype(np.float32)
    b = (0.3 * rng.randn(bt, l, n)).astype(np.float32)
    c = (0.3 * rng.randn(bt, l, n)).astype(np.float32)
    return x, a, b, c


@pytest.mark.parametrize("chunk", _ssd.CHUNKS)
@pytest.mark.parametrize("n", [16, 128])
def test_each_chunk_matches_the_pallas_scan(chunk, n):
    """At each instantiated chunk and both d_states of the kernel, over an
    l the chunk divides (so the reference's wrapper keeps the chunk):
    the port's ``ops.ssd_scan`` (its plain version) against the Pallas
    kernel in interpret mode and against the reference's ``ops.ssd_scan``
    at the same chunk."""
    bt, l, h, p = 1, 256, 2, 64
    arrs = _inputs(chunk + n, bt, l, h, p, n)
    ops.reset_launches()
    y, state = ops.ssd_scan(*(torch.from_numpy(t) for t in arrs),
                            chunk=chunk)
    assert not any(ops.LAUNCHES.values())
    for want_y, want_s in (
            jssd.ssd_scan(*(jnp.asarray(t) for t in arrs), chunk=chunk,
                          interpret=True),
            jops.ssd_scan(*(jnp.asarray(t) for t in arrs), chunk=chunk)):
        assert ref.compare(y, torch.from_numpy(np.asarray(want_y)),
                           normwise=True)[0]
        assert ref.compare(state, torch.from_numpy(np.asarray(want_s)),
                           normwise=True)[0]


@pytest.mark.parametrize("asked,runs", [(100, 64), (128, 128), (256, 128),
                                        (32, 32), (63, 32), (1000, 128)])
def test_a_chunk_snaps_down_to_an_instantiated_one(asked, runs):
    """The largest of ``CHUNKS`` not above the chunk asked for; the CPU
    path runs that chunk, bit for bit the plain version's at it."""
    assert ops.ssd_chunk(asked) == runs
    x, a, b, c = (torch.from_numpy(t) for t in _inputs(asked, 1, 70, 2, 8, 8))
    y, state = ops.ssd_scan(x, a, b, c, chunk=asked)
    wy, ws = ref.ssd_scan(x, a, b, c, chunk=runs)
    assert torch.equal(y, wy) and torch.equal(state, ws)


@pytest.mark.parametrize("asked", [16, 1, 0])
def test_a_chunk_below_the_smallest_raises(asked):
    x, a, b, c = (torch.from_numpy(t) for t in _inputs(0, 1, 8, 2, 8, 8))
    with pytest.raises(ValueError, match="ssd_scan chunk"):
        ops.ssd_scan(x, a, b, c, chunk=asked)


def test_the_default_chunk_is_the_references():
    assert _ssd.DEFAULT_CHUNK == 128 == max(_ssd.CHUNKS)
    assert ops.ssd_scan.__defaults__[-1] == _ssd.DEFAULT_CHUNK
    assert jops.ssd_scan.__defaults__[-1] == _ssd.DEFAULT_CHUNK


@pytest.mark.parametrize("chunk", _ssd.CHUNKS)
def test_a_meta_call_is_priced_at_the_chunk_that_runs(chunk):
    """The dry run's op for a meta call carries ``cost.ssd_scan`` at the
    snapped chunk (its causal FLOPs depend on the chunk)."""
    bt, l, h, p, n = 1, 300, 4, 64, 128
    meta = dict(device="meta")
    args = (torch.empty(bt, l, h, p, **meta), torch.empty(bt, l, h, **meta),
            torch.empty(bt, l, n, **meta), torch.empty(bt, l, n, **meta))
    trace = op_analysis.OpTrace()
    trace.run(lambda *t: ops.ssd_scan(*t, chunk=chunk + 1), *args)
    [op] = [o for o in trace.ops if o.name == "ssd_scan"]
    assert (op.nbytes, op.flops) == cost.ssd_scan(bt, l, h, p, n, 4, chunk)


@pytest.mark.parametrize("chunk,grid", [(32, (64, 32, 1)), (64, (64, 16, 1)),
                                        (128, (64, 8, 1))])
def test_grid_at_each_chunk(chunk, grid):
    """One CTA a (head x p-block, chunk, batch row) at l 1024, h 32, p 64;
    the hand-off's ints do not depend on the chunk."""
    assert _ssd.grid(1, 1024, 32, 64, chunk) == grid
    assert _ssd.grid(2, 1025, 32, 64, chunk)[1:] == (1024 // chunk + 1, 2)
    assert _ssd.sync_ints(1, 32, 64) == 128


@pytest.mark.parametrize("chunk", _ssd.CHUNKS)
def test_check_grid_at_each_chunk(chunk):
    """A chunk a y-block: at chunk c the grid holds l up to 65535 c."""
    _ssd.check_grid(1, 65535 * chunk, 32, 64, chunk)
    with pytest.raises(ValueError, match="65535"):
        _ssd.check_grid(1, 65535 * chunk + 1, 32, 64, chunk)


@pytest.fixture(scope="module")
def smoke_mixer():
    """Layer 0's mixer of the mamba2-370m smoke, carried across by the
    bridge, with each side's mixer config."""
    jcfg = jconfigs.get_smoke("mamba2-370m")
    jparams = JT.init_params(jax.random.PRNGKey(5), jcfg)
    cfg = configs.get_smoke("mamba2-370m")
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                             device="cpu")
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"][0]["mamba"])
    return jcfg.mamba_cfg(), jp, cfg.mamba_cfg(), params["blocks"][0]["mamba"]


def test_mamba_apply_scans_at_the_configs_chunk(smoke_mixer, monkeypatch):
    """``MambaConfig.chunk`` 64 on the smoke: the port's kernel branch
    against the reference's ``mamba_apply(use_kernel=True)`` at the same
    chunk (l 192: three chunks of 64 on both sides), and the chunk the
    port's branch hands ``ops.ssd_scan``."""
    jcfg, jp, cfg, tp = smoke_mixer
    jcfg, cfg = (dataclasses.replace(c, chunk=64) for c in (jcfg, cfg))
    x = np.random.RandomState(6).randn(2, 192, cfg.d_model) \
        .astype(np.float32)
    want, _ = jmamba.mamba_apply(jp, jcfg, jnp.asarray(x), use_kernel=True)
    seen = []
    real = ops.ssd_scan
    monkeypatch.setattr(ops, "ssd_scan", lambda *a, chunk, **k: (
        seen.append(chunk), real(*a, chunk=chunk, **k))[1])
    got, _ = mamba.mamba_apply(tp, cfg, torch.from_numpy(x))
    assert seen == [64]
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=MAMBA_TOL, rtol=MAMBA_TOL)
