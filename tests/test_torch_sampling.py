"""Threefry keys and the sampler of the PyTorch port against ``jax.random``.

The installed jax (0.9.0) runs the ``threefry2x32`` PRNG with
``jax_threefry_partitionable`` on. Keys, random bits and uniforms must be
bit-equal to JAX's; Gumbel noise goes through two ``log``s whose last bit
the two libraries may round apart, so a sampled token may differ from
JAX's only where the top two noisy logits lie within a few ulps (counted,
and asserted to be such a near-tie).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given
from hypothesis import strategies as st

from repro.serve import spec

from repro_torch.serve import sampling

VOCAB = 151_936                    # qwen3-4b's vocabulary
N_KEYS = 1002                      # 334 at each temperature
BATCH = 25                         # keys a batch: 25 x VOCAB int64 scratch
TEMPERATURES = (0.5, 1.0, 2.0)
NEAR_TIE_ULPS = 4
U32 = st.integers(0, 2**32 - 1)
I32 = st.integers(-2**31, 2**31 - 1)


def _key(seed):
    return np.asarray(jax.random.PRNGKey(seed))


def _torch(keys):
    return torch.from_numpy(np.asarray(keys).astype(np.int64))


@pytest.mark.parametrize("seed", [0, 3, 12345, 2**31 - 1, -1, -2**31])
def test_prng_key_matches_jax(seed):
    assert sampling.prng_key(seed).tolist() == _key(seed).tolist()


@given(U32, U32, I32)
def test_fold_in_matches_jax(k0, k1, datum):
    key = np.asarray([k0, k1], np.uint32)
    want = np.asarray(jax.random.fold_in(key, datum & 0xFFFFFFFF))
    got = sampling.fold_in(_torch(key), datum)
    assert got.tolist() == want.tolist()


@pytest.mark.parametrize("datum", [0, 1, 2**31 - 2, 2**31 - 1, -1, -2**31])
def test_fold_in_at_the_edges_of_int32(datum):
    key = _key(7)
    want = np.asarray(jax.random.fold_in(key, datum & 0xFFFFFFFF))
    assert sampling.fold_in(_torch(key), datum).tolist() == want.tolist()


@pytest.mark.parametrize("shape", [(1,), (7,), (3, 1000), (2, 3, 5)])
def test_random_bits_match_jax(shape):
    key = _key(11)
    want = np.asarray(jax.random.bits(key, shape)).astype(np.int64)
    got = sampling.random_bits(_torch(key), shape).numpy()
    np.testing.assert_array_equal(got, want)


def test_random_bits_of_a_batch_of_keys_match_vmapped_jax():
    keys = np.asarray(jax.vmap(lambda r: jax.random.fold_in(
        jax.random.PRNGKey(5), r))(jnp.arange(6)))
    want = np.asarray(jax.vmap(lambda k: jax.random.bits(k, (999,)))(keys))
    got = sampling.random_bits(_torch(keys), (999,)).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0),
                                   (float(np.finfo(np.float32).tiny), 1.0),
                                   (-2.0, 3.0)])
def test_uniform_matches_jax(lo, hi):
    key = _key(2)
    want = np.asarray(jax.random.uniform(key, (200_000,), minval=lo,
                                         maxval=hi))
    got = sampling.uniform(_torch(key), (200_000,), lo, hi).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_gumbel_matches_jax_to_the_last_bits_of_log():
    """Equal but for the rounding of the two ``log``s: within a few ulps
    of the largest noise a categorical's argmax compares (about 16, where
    an ulp is 1.9e-6)."""
    key = _key(4)
    want = np.asarray(jax.random.gumbel(key, (200_000,)))
    got = sampling.gumbel(_torch(key), (200_000,)).numpy()
    assert np.abs(got - want).max() <= NEAR_TIE_ULPS * np.spacing(
        np.float32(16))
    assert np.mean(got == want) > 0.5


def test_categorical_of_one_key_matches_jax():
    """One (2,) key draws the noise of the whole (rows, vocab) array, as
    ``jax.random.categorical`` does on batched logits."""
    logits = np.random.RandomState(0).standard_normal((4, 5000)).astype(
        np.float32)
    key = _key(9)
    want = np.asarray(jax.random.categorical(key, logits))
    got = sampling.categorical(_torch(key), torch.from_numpy(logits))
    np.testing.assert_array_equal(got.numpy(), want)


def _near_tie(noisy: np.ndarray, a: int, b: int) -> bool:
    top = max(abs(noisy[a]), abs(noisy[b]))
    return abs(noisy[a] - noisy[b]) <= NEAR_TIE_ULPS * np.spacing(top)


def test_sampler_matches_jax_over_a_thousand_keys():
    """``sampler(t)`` against the reference's jitted ``per_row_sampler(t)``
    at temperatures 0.5, 1 and 2 over 1,002 keys (a third at each), over
    qwen3-4b's vocabulary: a token that differs is a counted near-tie."""
    base = jax.random.PRNGKey(3)
    flips = 0
    share = N_KEYS // len(TEMPERATURES)
    for k, t in enumerate(TEMPERATURES):
        pick = jax.jit(spec.per_row_sampler(t))
        for start in range(k * share, (k + 1) * share, BATCH):
            rows = jnp.arange(start, min(start + BATCH, (k + 1) * share))
            keys = np.asarray(jax.vmap(
                lambda r: jax.random.fold_in(base, r))(rows))
            logits = np.random.RandomState(start).standard_normal(
                (len(rows), VOCAB)).astype(np.float32) * 3
            want = np.asarray(pick(logits, keys))
            tk, tl = _torch(keys), torch.from_numpy(logits)
            got = sampling.sampler(t)(tl, tk).numpy()
            for i in np.nonzero(got != want)[0]:
                inv = np.float32(1.0) / np.float32(t)
                noisy = (sampling.gumbel(tk[i], (VOCAB,))
                         + tl[i] * float(inv)).numpy()
                assert _near_tie(noisy, got[i], want[i]), (t, start + i)
                flips += 1
    print(f"sampler vs jax: {flips} flips in {N_KEYS} draws")
    assert flips <= 3, flips


def test_sampler_at_zero_temperature_is_argmax():
    logits = torch.randn(3, 50, generator=torch.Generator().manual_seed(0))
    assert torch.equal(sampling.sampler(0.0)(logits, None),
                       logits.argmax(-1))


@given(st.integers(0, 2**31 - 1))
def test_fold_row_keys_match_reference(seed):
    rng = np.random.RandomState(seed)
    rids = rng.randint(-2**31, 2**31 - 1, size=5, dtype=np.int64)
    rids[0] = -1
    ts = rng.randint(0, 2**31 - 1, size=5, dtype=np.int64)
    ts[1] = 2**31 - 1
    base = jax.random.PRNGKey(seed)
    want = np.asarray(spec.fold_row_keys(base, jnp.asarray(rids, jnp.int32),
                                         jnp.asarray(ts, jnp.int32)))
    got = sampling.fold_row_keys(_torch(base), torch.from_numpy(rids),
                                 torch.from_numpy(ts))
    assert got.tolist() == want.tolist()


@pytest.mark.parametrize("width", [1, 4])
def test_fold_span_keys_match_reference(width):
    rids = np.asarray([0, 7, -3, 2**31 - 1], np.int64)
    t0s = np.asarray([0, 1, 2**31 - 5, 40], np.int64)
    base = jax.random.PRNGKey(1)
    want = np.asarray(spec.fold_span_keys(base, jnp.asarray(rids, jnp.int32),
                                          jnp.asarray(t0s, jnp.int32),
                                          width))
    got = sampling.fold_span_keys(_torch(base), torch.from_numpy(rids),
                                  torch.from_numpy(t0s), width)
    assert tuple(got.shape) == (4, width, 2)
    assert got.tolist() == want.tolist()
