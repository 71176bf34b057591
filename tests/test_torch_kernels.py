"""Paged-attention kernels of the PyTorch port against the reference.

On the CPU the port's wrappers route to their plain versions
(``repro_torch.kernels.ref``); those are held against the reference's
Pallas kernels run in interpret mode (``repro.kernels.ops``) and against
the reference's oracles over ``gather_kv``. The CUDA kernels themselves are
held against the plain versions in ``test_torch_cuda.py``, on a card.

Tolerance: 1e-5 absolute in fp32. Both sides compute the same fp32
softmax; only the summation order differs (XLA's CPU backend, the Pallas
interpreter's blocked online softmax, torch's einsum).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels import ops as jops, ref as jref
from repro.serve import paged as jpaged

from repro_torch.kernels import ops, ref

ATOL = 1e-5


def _pool(rng, n_pages, ps, kvh, d):
    return (rng.randn(n_pages, ps, kvh, d).astype(np.float32),
            rng.randn(n_pages, ps, kvh, d).astype(np.float32))


def _tables(rng, b, max_pages, n_pages):
    """Shuffled, non-contiguous page tables (no page shared)."""
    perm = rng.permutation(np.arange(1, n_pages))[:b * max_pages]
    return perm.reshape(b, max_pages).astype(np.int32)


def _t(a):
    return torch.from_numpy(np.array(a))


DECODE_LENGTHS = {
    "ragged_with_zero": [0, 13, 32, 5],
    "mid_page": [3, 11, 19, 27],
    "full_table": [32, 1, 16, 8],
    "past_table": [40, 0, 2, 31],      # a drifting free slot: clamps
}


@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("case", sorted(DECODE_LENGTHS))
def test_plain_paged_decode_matches_reference(group, case):
    rng = np.random.RandomState(group * 7 + len(case))
    b, kvh, d, ps, max_pages, n_pages = 4, 2, 16, 8, 4, 20
    h = kvh * group
    kp, vp = _pool(rng, n_pages, ps, kvh, d)
    table = _tables(rng, b, max_pages, n_pages)
    lengths = np.asarray(DECODE_LENGTHS[case], np.int32)
    q = rng.randn(b, h, d).astype(np.float32)

    ops.reset_launches()
    got = ops.flash_decode_paged(_t(q), _t(kp), _t(vp), _t(table),
                                 _t(lengths)).numpy()
    assert ops.LAUNCHES == {"flash_decode_paged": 0,
                            "flash_attention_paged": 0}
    assert got.shape == (b, h, d) and got.dtype == np.float32
    pallas = np.asarray(jops.flash_decode_paged(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(table), jnp.asarray(lengths)))
    np.testing.assert_allclose(got, pallas, atol=ATOL, rtol=0)
    ck, cv = jpaged.gather_kv(jnp.asarray(kp), jnp.asarray(vp),
                              jnp.asarray(table))
    oracle = np.asarray(jref.flash_decode(
        jnp.asarray(q), ck, cv,
        jnp.minimum(jnp.asarray(lengths), max_pages * ps)))
    np.testing.assert_allclose(got, oracle, atol=ATOL, rtol=0)
    assert not got[lengths == 0].any()          # freed slots give zeros


PREFILL_STARTS = {
    "from_zero": [0, 0],
    "later_chunk": [8, 21],
    "past_table_end": [60, 56],        # start + sq > max_rows
}


@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("case", sorted(PREFILL_STARTS))
def test_plain_paged_prefill_matches_reference(group, case):
    rng = np.random.RandomState(group * 11 + len(case))
    b, sq, kvh, d, ps, max_pages, n_pages = 2, 8, 2, 16, 8, 8, 20
    h = kvh * group
    kp, vp = _pool(rng, n_pages, ps, kvh, d)
    table = _tables(rng, b, max_pages, n_pages)
    starts = np.asarray(PREFILL_STARTS[case], np.int32)
    q = rng.randn(b, sq, h, d).astype(np.float32)

    ops.reset_launches()
    got = ops.flash_attention_paged(_t(q), _t(kp), _t(vp), _t(table),
                                    _t(starts)).numpy()
    assert sum(ops.LAUNCHES.values()) == 0
    assert got.shape == (b, sq, h, d)
    pallas = np.asarray(jops.flash_attention_paged(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(table), jnp.asarray(starts)))
    np.testing.assert_allclose(got, pallas, atol=ATOL, rtol=0)
    if case == "from_zero":
        # Offset 0 over the first sq rows is the reference's causal
        # full-sequence oracle on the gathered view.
        ck, cv = jpaged.gather_kv(jnp.asarray(kp), jnp.asarray(vp),
                                  jnp.asarray(table))
        oracle = np.asarray(jref.flash_attention(
            jnp.asarray(q), ck[:, :sq], cv[:, :sq], causal=True))
        np.testing.assert_allclose(got, oracle, atol=ATOL, rtol=0)


def test_plain_prefill_past_table_end_sees_every_mapped_row():
    """A chunk running past the table's reach (start + sq > max_rows):
    query r sees every mapped row <= min(start + r, max_rows - 1). Held
    against a numpy oracle. The reference Pallas kernel gives this only
    when its query block spans the whole chunk (see ROADMAP Queue 3)."""
    rng = np.random.RandomState(3)
    b, sq, kvh, group, d, ps, max_pages, n_pages = 1, 16, 2, 2, 16, 8, 8, 12
    h = kvh * group
    kp, vp = _pool(rng, n_pages, ps, kvh, d)
    table = _tables(rng, b, max_pages, n_pages)
    start = 56
    q = rng.randn(b, sq, h, d).astype(np.float32)
    got = ref.flash_attention_paged(_t(q), _t(kp), _t(vp), _t(table),
                                    _t(np.asarray([start], np.int32)))
    kc, vc = kp[table[0]].reshape(-1, kvh, d), vp[table[0]].reshape(-1, kvh, d)
    want = np.zeros_like(q)
    for r in range(sq):
        last = min(start + r, max_pages * ps - 1)
        for head in range(h):
            s = kc[:last + 1, head // group] @ q[0, r, head] / np.sqrt(d)
            p = np.exp(s - s.max())
            want[0, r, head] = (p / p.sum()) @ vc[:last + 1, head // group]
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    # The Pallas kernel agrees when its query block is the whole chunk.
    pallas = np.asarray(jops.flash_attention_paged(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.asarray([start], jnp.int32), block_q=sq, block_k=ps))
    np.testing.assert_allclose(got.numpy(), pallas, atol=ATOL, rtol=0)


def test_plain_versions_keep_bf16_out_and_fp32_math():
    """bf16 in, bf16 out; the math is the fp32 math on the rounded
    inputs (the Pallas kernels' contract, not ``sdpa``'s)."""
    rng = np.random.RandomState(5)
    kp, vp = _pool(rng, 10, 4, 2, 8)
    table = _tables(rng, 2, 4, 10)
    q = rng.randn(2, 4, 8).astype(np.float32)
    lengths = np.asarray([7, 16], np.int32)
    bf = lambda a: _t(a).to(torch.bfloat16)          # noqa: E731
    got = ref.flash_decode_paged(bf(q), bf(kp), bf(vp), _t(table),
                                 _t(lengths))
    assert got.dtype == torch.bfloat16
    want = ref.flash_decode_paged(bf(q).float(), bf(kp).float(),
                                  bf(vp).float(), _t(table), _t(lengths))
    assert torch.equal(got, want.to(torch.bfloat16))


def test_wrappers_reject_what_the_kernels_do_not_take():
    q = torch.zeros(2, 4, 8)
    kp = torch.zeros(5, 4, 2, 8)
    table = torch.zeros(2, 3, dtype=torch.int32)
    lens = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError):          # head_dim mismatch
        ops.flash_decode_paged(q, torch.zeros(5, 4, 2, 16),
                               torch.zeros(5, 4, 2, 16), table, lens)
    with pytest.raises(ValueError):          # heads not a multiple of kvh
        ops.flash_decode_paged(torch.zeros(2, 3, 8), kp, kp, table, lens)
    with pytest.raises(ValueError):          # table batch mismatch
        ops.flash_decode_paged(q, kp, kp, table[:1], lens)
    with pytest.raises(TypeError):           # pool dtype != q dtype
        ops.flash_decode_paged(q, kp.double(), kp.double(), table, lens)
    with pytest.raises(ValueError):          # q rank
        ops.flash_attention_paged(q, kp, kp, table, lens)
