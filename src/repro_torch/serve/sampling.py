"""Threefry keys and the sampler, as integer and fp32 tensor math (port of
the parts of ``jax.random`` that the engine uses, of
``repro/serve/engine.py:sampler`` and of ``repro/serve/spec.py``'s
``per_row_sampler``, ``fold_row_keys`` and ``fold_span_keys``).

Bit-equal to jax 0.9.0's ``threefry2x32`` PRNG with
``jax_threefry_partitionable`` on (its default there) and 64-bit types off:

* a key is two 32-bit words, ``prng_key(seed)`` is ``(0, seed mod 2**32)``;
* ``fold_in(key, d)`` hashes the count pair ``(0, d)`` under the key;
* ``random_bits(key, shape)`` hashes the pairs (high, low word of each
  element's flat index) and XORs the two output words;
* ``uniform`` puts 23 of those bits in an fp32 mantissa in [1, 2), ``gumbel``
  is ``-log(-log(u))`` with u from ``uniform(tiny, 1)`` (its "low" mode), and
  ``categorical`` the argmax of logits plus Gumbel noise.

PyTorch has almost no uint32 arithmetic, so each 32-bit word is carried in
an int64 tensor and masked after every add and shift. The same code runs
on the CPU, on the card and inside a captured CUDA graph. There is no
generator and no global RNG state: every output is a function of its key
and its inputs. Keys and bits equal JAX's bit for bit; a sampled token can
differ only where the last bit of a ``log`` flips the argmax between two
near-equal maxima.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA                      # Threefry's key-schedule constant
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = float(np.finfo(np.float32).tiny)
_ONE_BITS = 0x3F800000                    # fp32 1.0


def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32 of the count pairs (x1, x2) under the key (k1, k2):
    20 rounds, all operands 32-bit words in int64 tensors (broadcast).
    The two words are updated in place after the first add, which makes
    them fresh tensors of the broadcast shape."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]).bitwise_and_(MASK)
    x2 = (x2 + ks[1]).bitwise_and_(MASK)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1.add_(x2).bitwise_and_(MASK)
            x2 = (x2 << r).bitwise_or_(x2 >> (32 - r)).bitwise_and_(MASK)
            x2.bitwise_xor_(x1)
        x1.add_(ks[(i + 1) % 3]).bitwise_and_(MASK)
        x2.add_(ks[(i + 2) % 3] + (i + 1)).bitwise_and_(MASK)
    return x1, x2


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: the (2,) int64 key (0, seed mod 2**32)."""
    return torch.tensor([0, seed & MASK], dtype=torch.int64, device=device)


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: keys (..., 2) and data (an int, or int
    tensor broadcast against the keys' leading dims) -> keys (..., 2). A
    negative datum folds as its uint32 bit pattern."""
    data = torch.as_tensor(data, dtype=torch.int64, device=keys.device)
    y1, y2 = threefry2x32(keys[..., 0], keys[..., 1],
                          torch.zeros_like(data), data & MASK)
    return torch.stack([y1, y2], dim=-1)


def random_bits(keys: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """32 random bits per element, the partitionable way: keys (..., 2) ->
    (..., *shape) int64 in [0, 2**32), each key hashing the flat indices
    of ``shape``."""
    shape = tuple(shape)
    idx = torch.arange(int(np.prod(shape, dtype=np.int64)), dtype=torch.int64,
                       device=keys.device).reshape(shape)
    lead = keys.shape[:-1] + (1,) * len(shape)
    y1, y2 = threefry2x32(keys[..., 0].reshape(lead),
                          keys[..., 1].reshape(lead), idx >> 32, idx & MASK)
    return y1 ^ y2


def uniform(keys: torch.Tensor, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """fp32 values in [minval, maxval): keys (..., 2) -> (..., *shape).
    XLA fuses the scale and the shift into one multiply-add, rounded once;
    here both are taken in fp64 and rounded once to fp32 (exact at scale
    1, where the sampler draws)."""
    bits = random_bits(keys, shape)
    floats = ((bits >> 9) | _ONE_BITS).to(torch.int32).view(torch.float32)
    lo, hi = np.float32(minval), np.float32(maxval)
    scaled = ((floats - 1.0).double() * float(hi - lo) + float(lo)).float()
    return torch.clamp_min(scaled, float(lo))


def gumbel(keys: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """Standard Gumbel noise in fp32, JAX's "low" mode."""
    return -torch.log(-torch.log(uniform(keys, shape, _TINY, 1.0)))


def categorical(keys: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits, axis=-1)``: the argmax of
    logits plus Gumbel noise. One (2,) key draws noise over the whole of
    ``logits``; keys (..., 2) whose leading dims are the logits' draw one
    row each, as ``jax.vmap`` of it over the rows does."""
    shape = logits.shape if keys.dim() == 1 else logits.shape[-1:]
    return torch.argmax(gumbel(keys, shape) + logits, dim=-1)


def sampler(temperature: float) -> Callable:
    """``(logits (..., vocab), keys) -> ids``: the reference's ``sampler``
    (one (2,) key) and ``spec.per_row_sampler`` (keys (..., 2), one a
    row) in one; greedy at temperature 0, where the keys are not read.

    The reference divides by the temperature inside a jitted step, where
    XLA turns the division by a constant into a product with its fp32
    reciprocal; so does this."""
    if temperature == 0.0:
        return lambda logits, keys=None: torch.argmax(logits, dim=-1)
    inv = float(np.float32(1.0) / np.float32(temperature))

    def sample(logits, keys):
        return categorical(keys, logits.float() * inv)

    return sample


def fold_row_keys(base_key: torch.Tensor, rids, ts) -> torch.Tensor:
    """(b,) request ids and (b,) emitted indices -> (b, 2) keys,
    fold_in(fold_in(base, rid), t) a row."""
    return fold_in(fold_in(base_key, rids), ts)


def fold_span_keys(base_key: torch.Tensor, rids, t0s,
                   width: int) -> torch.Tensor:
    """(b,) request ids and (b,) first emitted indices -> (b, width, 2),
    position j of row i keyed by (rids[i], t0s[i] + j)."""
    kb = fold_in(base_key, rids)                                  # (b, 2)
    t0s = torch.as_tensor(t0s, dtype=torch.int64, device=kb.device)
    ts = t0s[:, None] + torch.arange(width, device=kb.device)     # (b, w)
    return fold_in(kb[:, None, :].expand(-1, width, -1), ts)

