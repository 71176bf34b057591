"""Kernels of the PyTorch port against the reference: paged and
contiguous decode, paged prefill, and the SSD scan.

On the CPU the port's wrappers route to their plain versions
(``repro_torch.kernels.ref``); those are held against the reference's
Pallas kernels run in interpret mode (``repro.kernels.ops``) and against
the reference's oracles over ``gather_kv``. The CUDA kernels themselves are
held against the plain versions in ``test_torch_cuda.py``, on a card.

Tolerance: 1e-5 absolute in fp32. Both sides compute the same fp32
softmax; only the summation order differs (XLA's CPU backend, the Pallas
interpreter's blocked online softmax, torch's einsum). The SSD scan is
held to 2e-4 absolute plus relative, the reference's own tolerance for
its chunked against its sequential scan: the two sides cut the sequence
into chunks of other lengths, and a decay exp(a_cum[i] - a_cum[j]) is a
difference of cumulative sums that grow over a chunk.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels import ops as jops, ref as jref
from repro.kernels import ssd_scan as jssd
from repro.models import mamba as jmamba
from repro.serve import paged as jpaged

from repro_torch.kernels import ops, ref

ATOL = 1e-5
SSD_TOL = 2e-4


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
    assert set(ops.LAUNCHES) == {"flash_attention", "flash_decode_paged",
                                 "flash_attention_paged", "flash_decode",
                                 "ssd_scan", "gemm", "pchase",
                                 "pchase_timed"}
    assert not any(ops.LAUNCHES.values())
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


CONTIGUOUS_LENGTHS = {
    "ragged_with_zero": [0, 13, 32, 5],
    "full": [32, 32, 32, 32],
    "past_end": [40, 0, 2, 31],        # a drifting free slot: clamps
}


@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("case", sorted(CONTIGUOUS_LENGTHS))
def test_plain_contiguous_decode_matches_reference(group, case):
    """``ops.flash_decode`` on CPU tensors (its plain version) against the
    Pallas ``flash_decode`` in interpret mode and the reference's oracle,
    with zero, full and past-the-end lengths."""
    rng = np.random.RandomState(group * 5 + len(case))
    b, kvh, d, max_len = 4, 2, 16, 32
    h = kvh * group
    k = rng.randn(b, max_len, kvh, d).astype(np.float32)
    v = rng.randn(b, max_len, kvh, d).astype(np.float32)
    lengths = np.asarray(CONTIGUOUS_LENGTHS[case], np.int32)
    q = rng.randn(b, h, d).astype(np.float32)

    ops.reset_launches()
    got = ops.flash_decode(_t(q), _t(k), _t(v), _t(lengths)).numpy()
    assert not any(ops.LAUNCHES.values())
    assert got.shape == (b, h, d) and got.dtype == np.float32
    args = [jnp.asarray(a) for a in (q, k, v, lengths)]
    pallas = np.asarray(jops.flash_decode(*args, block_k=8))
    np.testing.assert_allclose(got, pallas, atol=ATOL, rtol=0)
    oracle = np.asarray(jref.flash_decode(*args))
    np.testing.assert_allclose(got, oracle, atol=ATOL, rtol=0)
    assert not got[lengths == 0].any()          # freed slots give zeros


def _ssd_inputs(rng, bt, l, h, p, n):
    x = rng.randn(bt, l, h, p).astype(np.float32)
    a = -np.abs(rng.randn(bt, l, h)).astype(np.float32) * 0.5
    b = rng.randn(bt, l, n).astype(np.float32) * 0.5
    c = rng.randn(bt, l, n).astype(np.float32) * 0.5
    return x, a, b, c


@pytest.mark.parametrize("l", [8, 40, 256])
def test_plain_ssd_scan_matches_pallas(l):
    """``ops.ssd_scan`` on CPU tensors (fixed chunk of 128, the last one
    masked) against the Pallas kernel in interpret mode at chunk 8 (l a
    multiple of it), from a zero state: y and the final state."""
    rng = np.random.RandomState(l)
    x, a, b, c = _ssd_inputs(rng, 2, l, 3, 8, 16)
    ops.reset_launches()
    y, state = ops.ssd_scan(_t(x), _t(a), _t(b), _t(c))
    assert not any(ops.LAUNCHES.values())
    assert y.dtype == torch.float32 and state.shape == (2, 3, 8, 16)
    wy, ws = jssd.ssd_scan(*(jnp.asarray(t) for t in (x, a, b, c)), chunk=8,
                           interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(wy), atol=SSD_TOL,
                               rtol=SSD_TOL)
    np.testing.assert_allclose(state.numpy(), np.asarray(ws), atol=SSD_TOL,
                               rtol=SSD_TOL)


@pytest.mark.parametrize("l", [1, 5, 127, 130, 131])
def test_plain_ssd_scan_matches_chunked_with_initial_state(l):
    """Ragged and prime lengths from a non-zero state: against the
    reference's ``ssd_chunked`` at the largest power-of-two chunk that
    divides l (1 at an odd length) and its sequential ``ssd_reference``."""
    rng = np.random.RandomState(l + 1)
    x, a, b, c = _ssd_inputs(rng, 2, l, 2, 4, 8)
    h0 = rng.randn(2, 2, 4, 8).astype(np.float32)
    y, state = ops.ssd_scan(_t(x), _t(a), _t(b), _t(c), h0=_t(h0))
    chunk = 128
    while l % chunk:
        chunk //= 2
    args = [jnp.asarray(t) for t in (x, a, b, c)]
    for wy, ws in (jmamba.ssd_chunked(*args, chunk, h0=jnp.asarray(h0)),
                   jmamba.ssd_reference(*args, h0=jnp.asarray(h0))):
        np.testing.assert_allclose(y.numpy(), np.asarray(wy), atol=SSD_TOL,
                                   rtol=SSD_TOL)
        np.testing.assert_allclose(state.numpy(), np.asarray(ws),
                                   atol=SSD_TOL, rtol=SSD_TOL)


def test_plain_ssd_scan_keeps_the_input_dtype_and_fp32_math():
    """bf16 x/b/c in, bf16 y out and an fp32 state: the fp32 math on the
    rounded inputs, rounded once."""
    rng = np.random.RandomState(9)
    x, a, b, c = _ssd_inputs(rng, 1, 20, 2, 4, 8)
    bf = lambda t: _t(t).to(torch.bfloat16)          # noqa: E731
    y, state = ops.ssd_scan(bf(x), _t(a), bf(b), bf(c))
    assert y.dtype == torch.bfloat16 and state.dtype == torch.float32
    wy, ws = ref.ssd_scan(bf(x).float(), _t(a), bf(b).float(), bf(c).float())
    assert torch.equal(y, wy.to(torch.bfloat16))
    assert torch.equal(state, ws)


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
    kc = torch.zeros(2, 16, 2, 8)
    with pytest.raises(ValueError):          # cache batch != q batch
        ops.flash_decode(q, kc[:1], kc[:1], lens)
    with pytest.raises(ValueError):          # lengths batch mismatch
        ops.flash_decode(q, kc, kc, lens[:1])
    with pytest.raises(TypeError):           # cache dtype != q dtype
        ops.flash_decode(q, kc.bfloat16(), kc.bfloat16(), lens)


def test_ssd_wrapper_rejects_what_the_kernel_does_not_take():
    x = torch.zeros(1, 6, 2, 4)
    a = torch.zeros(1, 6, 2)
    b = torch.zeros(1, 6, 8)
    with pytest.raises(ValueError):          # a_log shape
        ops.ssd_scan(x, a[:, :5], b, b)
    with pytest.raises(ValueError):          # b/c length
        ops.ssd_scan(x, a, b[:, :5], b[:, :5])
    with pytest.raises(ValueError):          # h0 shape
        ops.ssd_scan(x, a, b, b, h0=torch.zeros(1, 2, 4, 4))
    with pytest.raises(TypeError):           # b dtype != x dtype
        ops.ssd_scan(x, a, b.bfloat16(), b.bfloat16())
    with pytest.raises(TypeError):           # a_log not fp32
        ops.ssd_scan(x, a.double(), b, b)
    with pytest.raises(ValueError):          # no rows
        ops.ssd_scan(x[:, :0], a[:, :0], b[:, :0], b[:, :0])
