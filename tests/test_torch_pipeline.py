"""GPipe in the PyTorch port (``dist/pipeline.py``) on four gloo CPU
ranks against the reference's sequential stack: part 2 of the
reference's ``MULTIDEV_SCRIPT`` (``tests/test_sharding_dist.py``) ported
(4 stages, 6 microbatches of (5, 8), ``tanh(x @ w + b)``, numpy's
RandomState(0) drawn in the script's order), at its tolerance of 1e-4;
the bubble fraction equal to the reference's; a stage dim that is not
the axis size raises ``ValueError``. Rank functions in
``tests/_torch_train_workers.py``."""

import jax.numpy as jnp
import numpy as np
import pytest

from repro.dist import pipeline as jpipeline

from repro_torch.dist import pipeline
from repro_torch.launch import mesh as mesh_lib

import _torch_train_workers as workers

STAGES, MICRO = 4, 6


@pytest.fixture(scope="module")
def piped():
    rng = np.random.RandomState(0)
    rng.randn(16, 32), rng.randn(32, 24)     # the script's part 1 draws
    ws = {"w": (rng.randn(STAGES, 8, 8) * 0.5).astype(np.float32),
          "b": (rng.randn(STAGES, 8) * 0.1).astype(np.float32)}
    micro = rng.randn(MICRO, 5, 8).astype(np.float32)
    seq = jnp.asarray(micro)
    for i in range(STAGES):
        seq = jnp.tanh(seq @ jnp.asarray(ws["w"][i]) + jnp.asarray(
            ws["b"][i]))
    ranks = mesh_lib.run_ranks(workers.gpipe_rank, STAGES,
                               args=(ws, micro), deadline_s=90.0)
    return ranks, np.asarray(seq)


def test_gpipe_equals_the_sequential_stack(piped):
    ranks, seq = piped
    for r in ranks:                          # the output on every rank
        np.testing.assert_allclose(r["out"], seq, rtol=1e-4, atol=1e-4)


def test_a_wrong_stage_dim_raises(piped):
    for r in piped[0]:
        assert r["raised"] is not None and "stage dim 5" in r["raised"]


@pytest.mark.parametrize("stages,micro", [(4, 6), (2, 4), (1, 3), (8, 1)])
def test_bubble_fraction_matches_the_reference(stages, micro):
    assert pipeline.bubble_fraction(stages, micro) == \
        jpipeline.bubble_fraction(stages, micro)
    assert pipeline.bubble_fraction(4, 6) == pytest.approx(3 / 9, abs=1e-9)
