"""The CUDA kernels of the PyTorch port against their plain versions.

These tests need a CUDA card and ``nvcc`` (the kernels are compiled at
first use); on a machine without a card they skip. On the card:

    python -m pytest tests/test_torch_cuda.py

This file imports neither JAX nor the reference package, so it runs on a
machine that has only PyTorch.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.core import card, latency, pchase, simulator
from repro_torch.data import DataConfig, SyntheticLMData
from repro_torch.kernels import flash_decode
from repro_torch.kernels import gemm as gemm_kernel
from repro_torch.kernels import ops, ref
from repro_torch.kernels.gemm import TILES
from repro_torch.models import transformer as T
from repro_torch.serve import graphs, sampling, traffic
from repro_torch.serve.engine import (Request, ServeConfig, ServingEngine,
                                      SLOClass)
from repro_torch.serve.faults import FaultInjector, canonical_schedule
from repro_torch.train import steps
from repro_torch.tree import tree_items, tree_map


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are compiled by nvcc "
                    "and run only there")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 80, 96, 128])
def test_cuda_kernels_match_plain_versions(cuda_device, dtype, d):
    """Each CUDA kernel against its plain version on the card, at the
    main path's head counts (h 32, kvh 8, page 16), within
    ``ref.TOLERANCE`` (summation order; one rounding step in bf16)."""
    g = torch.Generator(device=cuda_device).manual_seed(d)
    b, h, kvh, ps, n_pages, max_pages = 8, 32, 8, 16, 600, 64
    mk = lambda *s: torch.randn(*s, generator=g, device=cuda_device,   # noqa
                                dtype=torch.float32).to(dtype)
    kp, vp = mk(n_pages, ps, kvh, d), mk(n_pages, ps, kvh, d)
    table = torch.stack([torch.randperm(n_pages - 1, generator=g,
                                        device=cuda_device)[:max_pages] + 1
                         for _ in range(b)]).int()
    lengths = torch.tensor([0, 1, 15, 16, 17, 333, 1000, 1024],
                           dtype=torch.int32, device=cuda_device)
    q = mk(b, h, d)
    ops.reset_launches()
    got = ops.flash_decode_paged(q, kp, vp, table, lengths)
    torch.cuda.synchronize()
    want = ref.flash_decode_paged(q, kp, vp, table, lengths)
    assert ref.compare(got, want)[0]
    starts = torch.tensor([0, 5, 64, 300, 900, 1000, 16, 1],
                          dtype=torch.int32, device=cuda_device)
    qc = mk(b, 100, h, d)
    got = ops.flash_attention_paged(qc, kp, vp, table, starts)
    torch.cuda.synchronize()
    want = ref.flash_attention_paged(qc, kp, vp, table, starts)
    assert ref.compare(got, want)[0]
    assert ops.LAUNCHES == {"flash_attention": 0, "flash_decode_paged": 1,
                            "flash_attention_paged": 1,
                            "flash_decode": 0, "ssd_scan": 0,
                            "gemm": 0, "pchase": 0,
                            "pchase_timed": 0}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 80, 96, 128])
def test_cuda_paged_prefill_at_the_verify_shape(cuda_device, dtype, d):
    """The speculative verify's attention: 8 slots of k + 1 rows (k 1, 2,
    4) from ragged starts: 0, across a page boundary, rows past the
    table's end (1022 + 5 > 64 pages of 16), and a freed slot whose table
    row is zero."""
    g = torch.Generator(device=cuda_device).manual_seed(100 + d)
    b, h, kvh, ps, n_pages, max_pages = 8, 32, 8, 16, 600, 64
    mk = lambda *s: torch.randn(*s, generator=g, device=cuda_device,   # noqa
                                dtype=torch.float32).to(dtype)
    kp, vp = mk(n_pages, ps, kvh, d), mk(n_pages, ps, kvh, d)
    table = torch.stack([torch.randperm(n_pages - 1, generator=g,
                                        device=cuda_device)[:max_pages] + 1
                         for _ in range(b)]).int()
    table[5] = 0
    starts = torch.tensor([0, 15, 16, 300, 1022, 7, 511, 1019],
                          dtype=torch.int32, device=cuda_device)
    for sq in (2, 3, 5):
        q = mk(b, sq, h, d)
        got = ops.flash_attention_paged(q, kp, vp, table, starts)
        torch.cuda.synchronize()
        ok, err = ref.compare(got, ref.flash_attention_paged(q, kp, vp,
                                                             table, starts))
        assert ok, (sq, err)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 80, 96, 128])
def test_cuda_contiguous_decode_matches_plain_version(cuda_device, dtype, d):
    """The contiguous decode kernel against its plain version, lengths
    with a 0, max_len and past max_len (a drifting free slot)."""
    g = torch.Generator(device=cuda_device).manual_seed(d + 1)
    b, h, kvh, max_len = 8, 32, 8, 1024
    mk = lambda *s: torch.randn(*s, generator=g, device=cuda_device,   # noqa
                                dtype=torch.float32).to(dtype)
    k, v, q = mk(b, max_len, kvh, d), mk(b, max_len, kvh, d), mk(b, h, d)
    lengths = torch.tensor([0, 1, 63, 64, 65, 700, 1024, 1500],
                           dtype=torch.int32, device=cuda_device)
    ops.reset_launches()
    got = ops.flash_decode(q, k, v, lengths)
    torch.cuda.synchronize()
    assert ref.compare(got, ref.flash_decode(q, k, v, lengths))[0]
    assert ops.LAUNCHES["flash_decode"] == 1
    assert not got[0].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [80, 128])
def test_cuda_contiguous_decode_lse_matches_plain_version(cuda_device, dtype,
                                                          d):
    """``return_lse``: each row's log-sum-exp against the plain version's
    (-inf at length 0), the output bit-equal to the default launch's."""
    g = torch.Generator(device=cuda_device).manual_seed(d + 7)
    b, h, kvh, max_len = 8, 32, 8, 1024
    mk = lambda *s: torch.randn(*s, generator=g, device=cuda_device,   # noqa
                                dtype=torch.float32).to(dtype)
    k, v, q = mk(b, max_len, kvh, d), mk(b, max_len, kvh, d), mk(b, h, d)
    lengths = torch.tensor([0, 1, 255, 256, 257, 700, 1024, 1500],
                           dtype=torch.int32, device=cuda_device)
    out, lse = ops.flash_decode(q, k, v, lengths, return_lse=True)
    want, want_lse = ref.flash_decode(q, k, v, lengths, return_lse=True)
    torch.cuda.synchronize()
    assert ref.compare(out, want)[0]
    assert torch.equal(out, ops.flash_decode(q, k, v, lengths))
    assert torch.isneginf(lse[0]).all()
    assert ref.compare(lse[1:], want_lse[1:])[0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 16, 16, 64, 256, 288),
                                   (4, 64, 8, 128, 512, 528)],
                         ids=["whisper-medium", "llama-3.2-vision-90b"])
def test_cuda_contiguous_decode_at_the_encdec_shapes(cuda_device, dtype,
                                                     shape):
    """The contiguous decode at whisper-medium's decode shape (MHA, 16
    heads of 64: a bf16 query block of 16 rows holds one live row) and
    llama-3.2-vision-90b's (64 heads of 128 over 8 kv heads, group 8),
    contexts as greedy_generate's last steps reach them, against its
    plain version."""
    b, h, kvh, d, lo, hi = shape
    g = torch.Generator(device=cuda_device).manual_seed(d + h)
    mk = lambda *s: torch.randn(*s, generator=g, device=cuda_device,   # noqa
                                dtype=torch.float32).to(dtype)
    k, v, q = mk(b, hi, kvh, d), mk(b, hi, kvh, d), mk(b, h, d)
    lengths = torch.tensor(np.linspace(lo, hi, b).astype(np.int32),
                           device=cuda_device)
    ops.reset_launches()
    got = ops.flash_decode(q, k, v, lengths)
    torch.cuda.synchronize()
    ok, err = ref.compare(got, ref.flash_decode(q, k, v, lengths))
    assert ok, err
    assert ops.LAUNCHES["flash_decode"] == 1


# Lengths about the split decode's 256-row boundaries over a reach of 1024
# rows (4 splits): 0 (every split empty), 1, each boundary and one row
# either side, the reach, and past it (a drifting free slot).
SPLIT_LENGTHS = [0, 1, 255, 256, 257, 511, 512, 513, 767, 768, 769, 1023,
                 1024, 1500]


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "contiguous"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 80, 96, 128])
def test_cuda_decodes_across_split_boundaries(cuda_device, paged, dtype, d):
    """Both decode kernels against their plain versions at groups 1, 4
    and 7 over kvh 2 (qwen2-0.5b's is 7) and the main path's 32 / 8, with
    lengths straddling the splits, within ``ref.TOLERANCE``: zero-length
    slots give exact zeros, each call counts one launch, and a second
    launch on the same inputs gives the same bits (the splits merge in a
    fixed order, no atomics)."""
    g = torch.Generator(device=cuda_device).manual_seed(d + 7 * paged)
    ps, max_pages = 16, 64
    b = len(SPLIT_LENGTHS)
    lengths = torch.tensor(SPLIT_LENGTHS, dtype=torch.int32,
                           device=cuda_device)
    mk = lambda *s: torch.randn(*s, generator=g, device=cuda_device)  # noqa
    for h, kvh in ((2, 2), (8, 2), (14, 2), (32, 8)):
        q = mk(b, h, d).to(dtype)
        if paged:
            n_pages = 1 + b * max_pages
            kv = [mk(n_pages, ps, kvh, d).to(dtype) for _ in range(2)]
            perm = torch.randperm(n_pages - 1, generator=g,
                                  device=cuda_device) + 1
            table = perm.reshape(b, max_pages).int()
            args = (q, *kv, table, lengths)
            run, plain = ops.flash_decode_paged, ref.flash_decode_paged
        else:
            kv = [mk(b, max_pages * ps, kvh, d).to(dtype) for _ in range(2)]
            args = (q, *kv, lengths)
            run, plain = ops.flash_decode, ref.flash_decode
        ops.reset_launches()
        got = run(*args)
        again = run(*args)
        torch.cuda.synchronize()
        ok, err = ref.compare(got, plain(*args))
        assert ok, (h, kvh, err)
        assert not got[0].any()
        assert torch.equal(got, again), (h, kvh)
        assert sum(ops.LAUNCHES.values()) == 2
        assert ops.LAUNCHES["flash_decode_paged" if paged
                            else "flash_decode"] == 2
    # The merge's counters are left at zero for the next launch.
    assert not any(c.any() for c in flash_decode._COUNTERS.values())


@pytest.mark.parametrize("block_q", [16, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [80, 96])
def test_cuda_prefill_tiles_match_plain_versions(cuda_device, block_q, dtype,
                                                 d):
    """Each instantiated query block of both prefill bodies against the
    plain version: the paged prefill at the verify's shape (8 slots x 5
    rows, ragged starts, a freed slot) and at a 100-row chunk, and the
    full-sequence attention causal and not (100 queries, 300 keys), each
    launch counted once."""
    g = torch.Generator(device=cuda_device).manual_seed(block_q + d)
    b, h, kvh, ps, n_pages, max_pages = 8, 32, 8, 16, 600, 64
    mk = lambda *s: torch.randn(*s, generator=g, device=cuda_device,   # noqa
                                dtype=torch.float32).to(dtype)
    kp, vp = mk(n_pages, ps, kvh, d), mk(n_pages, ps, kvh, d)
    table = torch.stack([torch.randperm(n_pages - 1, generator=g,
                                        device=cuda_device)[:max_pages] + 1
                         for _ in range(b)]).int()
    table[5] = 0
    starts = torch.tensor([0, 15, 16, 300, 1022, 7, 511, 919],
                          dtype=torch.int32, device=cuda_device)
    ops.reset_launches()
    for sq in (5, 100):
        q = mk(b, sq, h, d)
        got = ops.flash_attention_paged(q, kp, vp, table, starts,
                                        block_q=block_q)
        torch.cuda.synchronize()
        ok, err = ref.compare(got, ref.flash_attention_paged(q, kp, vp,
                                                             table, starts))
        assert ok, (sq, err)
    q, k, v = mk(2, 100, h, d), mk(2, 300, kvh, d), mk(2, 300, kvh, d)
    for causal in (True, False):
        got = ops.flash_attention(q, k, v, causal=causal, block_q=block_q)
        torch.cuda.synchronize()
        ok, err = ref.compare(got, ref.flash_attention(q, k, v,
                                                       causal=causal))
        assert ok, (causal, err)
    assert ops.LAUNCHES["flash_attention_paged"] == 2
    assert ops.LAUNCHES["flash_attention"] == 2


@pytest.mark.parametrize("block_k", flash_decode.SPLIT_ROWS_SET)
@pytest.mark.parametrize("paged", [True, False], ids=["paged", "contiguous"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [80, 96])
def test_cuda_decode_splits_match_plain_versions(cuda_device, block_k, paged,
                                                 dtype, d):
    """Each split length of both decodes against the plain version (GQA
    32 / 8 and MHA 32 / 32), lengths straddling the splits; a second
    launch gives the same bits (one split length, one summation order)."""
    g = torch.Generator(device=cuda_device).manual_seed(block_k + d)
    ps, max_pages = 16, 64
    b = len(SPLIT_LENGTHS)
    lengths = torch.tensor(SPLIT_LENGTHS, dtype=torch.int32,
                           device=cuda_device)
    mk = lambda *s: torch.randn(*s, generator=g, device=cuda_device)  # noqa
    for h, kvh in ((32, 8), (32, 32)):
        q = mk(b, h, d).to(dtype)
        if paged:
            n_pages = 1 + b * max_pages
            kv = [mk(n_pages, ps, kvh, d).to(dtype) for _ in range(2)]
            perm = torch.randperm(n_pages - 1, generator=g,
                                  device=cuda_device) + 1
            args = (q, *kv, perm.reshape(b, max_pages).int(), lengths)
            run, plain = ops.flash_decode_paged, ref.flash_decode_paged
        else:
            kv = [mk(b, max_pages * ps, kvh, d).to(dtype) for _ in range(2)]
            args = (q, *kv, lengths)
            run, plain = ops.flash_decode, ref.flash_decode
        got = run(*args, block_k=block_k)
        again = run(*args, block_k=block_k)
        torch.cuda.synchronize()
        ok, err = ref.compare(got, plain(*args))
        assert ok, (h, kvh, err)
        assert torch.equal(got, again), (h, kvh)


def test_cuda_prefill_entries_refuse_an_uninstantiated_block_q(cuda_device):
    """The C entries launch nothing at a query block the build does not
    instantiate (the wrappers snap before they get there)."""
    from repro_torch.kernels import flash_attention as prefill
    q = torch.zeros(1, 8, 4, 80, device=cuda_device, dtype=torch.bfloat16)
    kv = torch.zeros(1, 8, 2, 80, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="error -1"):
        prefill.flash_attention(q, kv, kv, True, torch.empty_like(q), 32)


# (bt, l) of the SSD scan: one row, one chunk of 128 and either side of
# it, ragged lengths, the longest prompt; batch 1 as the engine prefills.
SSD_CASES = [(2, 1), (2, 127), (2, 128), (2, 129), (2, 300), (2, 1536),
             (1, 129), (1, 1024)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bt,l", SSD_CASES)
def test_cuda_ssd_scan_matches_plain_version(cuda_device, dtype, bt, l):
    """The SSD scan kernel against its plain version at the main path's
    head shape (h 32, p 64, n 128), from a zero and a non-zero state,
    within ``ref.TOLERANCE`` scaled by the output's magnitude
    (``normwise``: see ``ref.compare``). The state is fp32 in both; y is
    compared in x's dtype. A second launch gives the same bits (the
    chunks hand the state on in a fixed order), and the hand-off's
    tickets and counts are left at zero."""
    g = torch.Generator(device=cuda_device).manual_seed(l + bt)
    h, p, n = 32, 64, 128
    mk = lambda *s: torch.randn(*s, generator=g, device=cuda_device)   # noqa
    x = mk(bt, l, h, p).to(dtype)
    a = -mk(bt, l, h).abs() * 0.1
    b, c = (mk(bt, l, n).mul(0.3).to(dtype) for _ in range(2))
    for h0 in (None, mk(bt, h, p, n)):
        ops.reset_launches()
        y, state = ops.ssd_scan(x, a, b, c, h0=h0)
        y2, state2 = ops.ssd_scan(x, a, b, c, h0=h0)
        torch.cuda.synchronize()
        wy, ws = ref.ssd_scan(x, a, b, c, h0=h0)
        assert ref.compare(y, wy, normwise=True)[0]
        assert ref.compare(state, ws, normwise=True)[0]
        assert torch.equal(y, y2) and torch.equal(state, state2)
        assert ops.LAUNCHES["ssd_scan"] == 2
    assert not any(c.any() for c in flash_decode._COUNTERS.values())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bt,l", SSD_CASES)
def test_cuda_ssd_scan_at_jambas_shape_matches_plain_version(cuda_device,
                                                             dtype, bt, l):
    """The same at jamba-v0.1's head shape (h 128, p 64, n 16), where two
    warps own the (32 x 16) state block of a CTA: within the tolerance,
    the same bits from a second launch, the hand-off's ints at zero."""
    g = torch.Generator(device=cuda_device).manual_seed(l + bt)
    h, p, n = 128, 64, 16
    mk = lambda *s: torch.randn(*s, generator=g, device=cuda_device)   # noqa
    x = mk(bt, l, h, p).to(dtype)
    a = -mk(bt, l, h).abs() * 0.1
    b, c = (mk(bt, l, n).mul(0.3).to(dtype) for _ in range(2))
    for h0 in (None, mk(bt, h, p, n)):
        y, state = ops.ssd_scan(x, a, b, c, h0=h0)
        y2, state2 = ops.ssd_scan(x, a, b, c, h0=h0)
        torch.cuda.synchronize()
        wy, ws = ref.ssd_scan(x, a, b, c, h0=h0)
        assert ref.compare(y, wy, normwise=True)[0]
        assert ref.compare(state, ws, normwise=True)[0]
        assert torch.equal(y, y2) and torch.equal(state, state2)
    assert not any(c.any() for c in flash_decode._COUNTERS.values())


@pytest.mark.parametrize("chunk", [32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(32, 64, 128), (128, 64, 16)])
def test_cuda_ssd_scan_at_each_chunk_matches_plain_version(cuda_device,
                                                           shape, dtype,
                                                           chunk):
    """Each chunk the kernel instantiates, at mamba2-370m's and jamba's
    head shapes, against the plain version at the same chunk (within the
    tolerance, scaled as above), at lengths either side of one and two
    chunks and a prime one, from a zero and a given state: two launches
    give the same bits, each is counted, the hand-off's ints stay zero."""
    from repro_torch.kernels import ssd_scan as ssd_mod
    assert chunk in ssd_mod.CHUNKS
    g = torch.Generator(device=cuda_device).manual_seed(chunk)
    h, p, n = shape
    mk = lambda *s: torch.randn(*s, generator=g, device=cuda_device)   # noqa
    for bt, l in ((2, chunk - 1), (2, chunk + 1), (1, 2 * chunk + 1),
                  (1, 1031)):
        x = mk(bt, l, h, p).to(dtype)
        a = -mk(bt, l, h).abs() * 0.1
        b, c = (mk(bt, l, n).mul(0.3).to(dtype) for _ in range(2))
        for h0 in (None, mk(bt, h, p, n)):
            ops.reset_launches()
            y, state = ops.ssd_scan(x, a, b, c, h0=h0, chunk=chunk)
            y2, state2 = ops.ssd_scan(x, a, b, c, h0=h0, chunk=chunk)
            torch.cuda.synchronize()
            wy, ws = ref.ssd_scan(x, a, b, c, h0=h0, chunk=chunk)
            assert ref.compare(y, wy, normwise=True)[0]
            assert ref.compare(state, ws, normwise=True)[0]
            assert torch.equal(y, y2) and torch.equal(state, state2)
            assert ops.LAUNCHES["ssd_scan"] == 2
    assert not any(c.any() for c in flash_decode._COUNTERS.values())


def test_cuda_ssd_scan_refuses_an_uninstantiated_chunk(cuda_device):
    """The C entry launches nothing at a chunk the build does not
    instantiate (the wrapper snaps before it gets there)."""
    from repro_torch.kernels import ssd_scan as ssd_mod
    x = torch.zeros(1, 8, 2, 64, device=cuda_device)
    a = torch.zeros(1, 8, 2, device=cuda_device)
    bc = torch.zeros(1, 8, 16, device=cuda_device)
    y, state = torch.empty_like(x), torch.empty(1, 2, 64, 16,
                                                device=cuda_device)
    with pytest.raises(RuntimeError, match="error -1"):
        ssd_mod.ssd_scan(x, a, bc, bc, None, y, state, 96)
    assert ops.ssd_scan(x, a, bc, bc, chunk=96)[0].shape == x.shape


def test_cuda_kernels_refuse_shapes_they_do_not_build(cuda_device):
    """A head_dim or an SSD (p, n) that no instance covers raises before a
    launch; nothing falls back to a plain version."""
    q = torch.zeros(2, 4, 112, device=cuda_device)
    kv = torch.zeros(2, 64, 2, 112, device=cuda_device)
    lens = torch.ones(2, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="head_dim"):
        ops.flash_decode(q, kv, kv, lens)
    x = torch.zeros(1, 8, 2, 64, device=cuda_device)
    a = torch.zeros(1, 8, 2, device=cuda_device)
    bc = torch.zeros(1, 8, 32, device=cuda_device)
    with pytest.raises(ValueError, match="d_state"):
        ops.ssd_scan(x, a, bc, bc)


# Ragged edges in every dim (1, 127, 4097), k or n off the 16-byte load
# width (the scalar path in fp32, the element loader in bf16), an empty
# k, ragged tiles that TMA can address (k and n multiples of 8), and the
# qwen3-4b MLP shapes.
GEMM_SHAPES = [(1, 1, 1), (127, 127, 127), (1, 4097, 127), (127, 1, 4097),
               (4097, 127, 1), (64, 256, 127), (5, 0, 7), (130, 300, 72),
               (129, 200, 264), (4097, 4104, 8),
               (2048, 2560, 9728), (2048, 9728, 2560)]


def _gemm_path(dtype, k, n):
    """The path the C entry point must report: fp32 on the CUDA cores;
    bf16 on the tensor cores, through TMA where its rows have 16-byte
    strides."""
    if dtype == torch.float32:
        return "cuda cores"
    if k > 0 and k % 8 == 0 and n % 8 == 0:
        return "wgmma + TMA"
    return "wgmma + element loads"


@pytest.mark.parametrize("dtype,tile", [(dt, t) for dt in TILES
                                        for t in TILES[dt]], ids=str)
def test_cuda_gemm_matches_plain_version(cuda_device, dtype, tile):
    """The GEMM kernel with each instantiated tile of each dtype against
    its plain version (fp32 sum, one rounding), within ``ref.TOLERANCE``
    scaled by the output's magnitude (``normwise``: outputs grow with
    sqrt(k)), through the path its dtype and shape call for: the MLP
    shapes in bf16 run wgmma fed by TMA. fp32 products stay fp32 on both
    sides (no TF32)."""
    assert not torch.backends.cuda.matmul.allow_tf32
    g = torch.Generator(device=cuda_device).manual_seed(7)
    for m, k, n in GEMM_SHAPES:
        x = torch.randn(m, k, generator=g, device=cuda_device).to(dtype)
        y = torch.randn(k, n, generator=g, device=cuda_device).to(dtype)
        ops.reset_launches()
        gemm_kernel.last_path = None
        got = ops.gemm(x, y, block=tile)
        torch.cuda.synchronize()
        ok, err = ref.compare(got, ref.gemm(x, y), normwise=True)
        assert ok, ((m, k, n), err)
        assert got.dtype == dtype and got.shape == (m, n)
        assert ops.LAUNCHES["gemm"] == 1
        assert gemm_kernel.last_path == _gemm_path(dtype, k, n), (m, k, n)


def test_cuda_gemm_refuses_what_the_kernel_does_not_take(cuda_device):
    x = torch.randn(33, 7, device=cuda_device)
    y = torch.randn(7, 9, device=cuda_device)
    with pytest.raises(ValueError, match="aligned"):
        ops.gemm(x[1:], y)                   # base 28 bytes past alignment
    with pytest.raises(ValueError, match="contiguous"):
        ops.gemm(x, y.t().contiguous().t())
    with pytest.raises(ValueError, match="tile"):
        ops.gemm(x, y, block=(32, 16, 32))
    with pytest.raises(ValueError, match="devices"):
        ops.gemm(x, y.cpu())


def _perm_chain(n, seed):
    rng = np.random.RandomState(seed)
    perm = rng.permutation(n).astype(np.int32)
    chain = np.empty(n, np.int32)
    chain[perm] = np.roll(perm, -1)
    return chain


def test_cuda_pchase_matches_plain_version(cuda_device):
    """The pointer chase bit-equal to its plain version: a 128-entry
    permutation, a strided chain, steps past n, a line chain of 1 MiB."""
    chains = [(torch.from_numpy(_perm_chain(128, 4)), 64),
              (torch.from_numpy(_perm_chain(128, 4)), 1000),
              ((torch.arange(4096) + 32) % 4096, 5000),
              (latency.line_chain(2**20, device="cpu"), latency.STEPS)]
    for chain, steps in chains:
        chain = chain.int().to(cuda_device)
        ops.reset_launches()
        got = ops.pchase(chain, steps)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), ref.pchase(chain, steps).cpu())
        assert ops.LAUNCHES["pchase"] == 1
    chain[0] = chain.shape[0]                # a write after the check
    with pytest.raises(ValueError, match="outside"):
        ops.pchase(chain, 4)
    with pytest.raises(ValueError, match="int32"):
        ops.pchase(chain.long(), 4)


@pytest.mark.parametrize("bypass_l1", [False, True])
def test_cuda_pchase_timed_matches_plain_version(cuda_device, bypass_l1):
    """The timed chase visits the plain version's offsets bit for bit
    (a permutation, a strided chain from an offset start after untimed
    steps), with a positive cycle count a load and a walk's total no less
    than the loads' sum; one launch counted under ``pchase_timed``; an
    offset outside the chain refused after the launch."""
    rng = np.random.RandomState(3)
    perm = rng.permutation(512)
    ring = np.zeros(512, np.int64)
    ring[perm] = np.roll(perm, -1) * 8
    for chain, steps, start, warm in ((ring, 2000, 0, 0),
                                      (simulator.make_chain(2**16, 64), 900,
                                       128, 9)):
        t = torch.from_numpy(chain).to(cuda_device)
        want = ref.pchase_timed(t, steps, start=start, warm=warm)
        ops.reset_launches()
        got, cycles, total = ops.pchase_timed(t, steps, start=start,
                                              warm=warm, bypass_l1=bypass_l1)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert cycles.dtype == torch.int32 and int(cycles.min()) > 0
        assert int(total.item()) >= int(cycles.long().sum())
        assert ops.LAUNCHES == dict(dict.fromkeys(ops.LAUNCHES, 0),
                                    pchase_timed=1)
    bad = torch.full((16,), 3, dtype=torch.int64, device=cuda_device)
    with pytest.raises(ValueError, match="outside the chain"):
        ops.pchase_timed(bad, 4, bypass_l1=bypass_l1)


def test_cuda_card_latency_classes_rise(cuda_device):
    """Through ``CardHierarchy`` and the reference's detectors: an L1
    hit, then an L2 hit (the L1 thrashed by four times 256 KiB), then
    device memory (a warm footprint four times the L2) rise strictly."""
    snapper = card.ClassSnapper()
    h = card.CardHierarchy(cuda_device, snapper=snapper)
    l1 = pchase.latency_classes(h, span=4 * 2**10).l1_hit
    l2 = pchase.measure_next_level_latency(h, 256 * 2**10)
    h.release()
    g = card.CardHierarchy(cuda_device, bypass_l1=True, snapper=snapper,
                           repeats=1)
    memory = card.warm_class(g, 200 * 2**20, 128)
    g.release()
    assert 0 < l1 < l2 < memory, (l1, l2, memory)


def test_cuda_card_chase_follows_a_make_chain_chain(cuda_device):
    """``CardHierarchy.chase``, the simulator's ``chase`` on the card: a
    4 KiB chain at 8 bytes from a flushed card reads the cold classes (an
    L1 hit the fastest) and checks the offsets it visited."""
    h = card.CardHierarchy(cuda_device)
    lat = h.chase(simulator.make_chain(4 * 2**10, 8), steps=512, flush=True)
    h.release()
    assert lat.shape == (512,) and lat.dtype == np.int64
    assert lat.min() > 0 and lat[0] > lat.min()


@pytest.mark.parametrize("d", [64, 80, 96, 128])
def test_cuda_paged_prefill_bf16_matches_plain_version(cuda_device, d):
    """The bf16 paged prefill (the tensor-core body) at the main path's
    chunk of 256 rows and head counts: chunks at start 0 and later, one
    running past the table's end, over shuffled tables, within
    ``ref.TOLERANCE``."""
    g = torch.Generator(device=cuda_device).manual_seed(d + 2)
    b, h, kvh, ps, max_pages, chunk = 8, 32, 8, 16, 128, 256
    n_pages = 1 + b * max_pages
    mk = lambda *s: torch.randn(*s, generator=g, device=cuda_device   # noqa
                                ).bfloat16()
    kp, vp = mk(n_pages, ps, kvh, d), mk(n_pages, ps, kvh, d)
    perm = torch.randperm(n_pages - 1, generator=g, device=cuda_device) + 1
    table = perm.reshape(b, max_pages).int()
    starts = torch.tensor([0, 256, 1024, 1536, 1792, 1900, 100, 17],
                          dtype=torch.int32, device=cuda_device)
    qc = mk(b, chunk, h, d)
    ops.reset_launches()
    got = ops.flash_attention_paged(qc, kp, vp, table, starts)
    torch.cuda.synchronize()
    ok, err = ref.compare(got, ref.flash_attention_paged(qc, kp, vp, table,
                                                         starts))
    assert ok, err
    assert ops.LAUNCHES["flash_attention_paged"] == 1


# (sq, skv): 1, a prime, a full sequence, and a query block against a
# longer key range (the causal diagonal offset by skv - sq).
FLASH_LENGTHS = [(1, 1), (127, 127), (300, 1031), (2048, 2048)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 80, 96, 128])
def test_cuda_flash_attention_matches_plain_version(cuda_device, causal,
                                                    dtype, d):
    """The full-sequence kernel against its plain version at groups 1, 4
    and 7 (qwen3-4b's and qwen2-0.5b's) and the lengths above, within
    ``ref.TOLERANCE``."""
    g = torch.Generator(device=cuda_device).manual_seed(d)
    mk = lambda *s: torch.randn(*s, generator=g, device=cuda_device   # noqa
                                ).to(dtype)
    for group, kvh in ((1, 2), (4, 2), (7, 2)):
        for sq, skv in FLASH_LENGTHS:
            q, k, v = mk(2, sq, group * kvh, d), mk(2, skv, kvh, d), \
                mk(2, skv, kvh, d)
            ops.reset_launches()
            got = ops.flash_attention(q, k, v, causal=causal)
            torch.cuda.synchronize()
            ok, err = ref.compare(got, ref.flash_attention(q, k, v,
                                                           causal=causal))
            assert ok, (group, sq, skv, err)
            assert ops.LAUNCHES["flash_attention"] == 1


def test_cuda_kernels_refuse_to_run_inside_a_gradient(cuda_device):
    """Every wrapper raises on a CUDA input that requires grad while grad
    mode is on, before launching anything."""
    mk = lambda *s: torch.randn(*s, device=cuda_device)   # noqa: E731
    q4, k4, pool = mk(1, 64, 8, 64), mk(1, 64, 2, 64), mk(5, 16, 2, 64)
    table = torch.tensor([[1, 2, 3, 4]], dtype=torch.int32,
                         device=cuda_device)
    n = torch.tensor([64], dtype=torch.int32, device=cuda_device)
    calls = [(ops.flash_attention, (q4, k4, k4)),
             (ops.flash_decode_paged, (q4[:, 0], pool, pool, table, n)),
             (ops.flash_attention_paged, (q4, pool, pool, table, n - 64)),
             (ops.flash_decode, (q4[:, 0].contiguous(), k4, k4, n)),
             (ops.ssd_scan, (mk(1, 8, 2, 64), -mk(1, 8, 2).abs(),
                             mk(1, 8, 128), mk(1, 8, 128))),
             (ops.gemm, (mk(64, 64), mk(64, 64)))]
    ops.reset_launches()
    for fn, args in calls:
        tracked = (args[0].clone().requires_grad_(),) + args[1:]
        with pytest.raises(RuntimeError, match="no backward"):
            fn(*tracked)
    assert not any(ops.LAUNCHES.values())
    with torch.no_grad():
        for fn, args in calls:
            fn(args[0].clone().requires_grad_(), *args[1:])
    torch.cuda.synchronize()
    assert all(ops.LAUNCHES[k] == 1 for k in ("flash_attention", "gemm",
                                              "ssd_scan", "flash_decode"))


def test_cuda_train_steps_match_cpu(cuda_device):
    """Three train steps of the qwen3-4b smoke model (fp32) on the card
    and on the CPU from the same parameters: losses within 1e-4, the
    parameters within a tenth of the learning rate (the bound of
    ``tests/test_torch_train.py``; the card's embedding backward sums
    with atomics, in no fixed order)."""
    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = configs.get_smoke("qwen3-4b")
    cpu = steps.init_state(cfg, device="cpu").tree()
    card = tree_map(lambda t: t.to(cuda_device), cpu)
    step = steps.make_train_step(cfg)
    data = SyntheticLMData(DataConfig(vocab=cfg.vocab, seq_len=16,
                                      global_batch=4))
    lr_max = 0.0
    for i in range(3):
        tokens, labels = (torch.from_numpy(a) for a in data.batch_at(i))
        cpu, m_cpu = step(cpu, {"tokens": tokens, "labels": labels})
        card, m_card = step(card, {"tokens": tokens.to(cuda_device),
                                   "labels": labels.to(cuda_device)})
        assert abs(float(m_cpu["loss"]) - float(m_card["loss"])) <= 1e-4
        lr_max = max(lr_max, float(m_cpu["lr"]))
    want = dict(tree_items(cpu["params"]))
    for key, p in tree_items(card["params"]):
        assert float((p.cpu() - want[key]).abs().max()) <= 0.1 * lr_max, key
    flash = steps.make_train_step(dataclasses.replace(cfg, use_flash=True))
    with pytest.raises(RuntimeError, match="no backward"):
        flash(card, {"tokens": tokens.to(cuda_device),
                     "labels": labels.to(cuda_device)})


# A small bf16 attention stack at a head_dim the kernels take (64), and a
# Mamba-2 stack at the SSD kernel's (p, n) = (64, 128).
GRAPH_CFGS = {
    "attn": dataclasses.replace(configs.get_smoke("qwen3-4b"), d_model=256,
                                d_ff=512, vocab=1000,
                                compute_dtype="bfloat16"),
    "mamba": dataclasses.replace(configs.get_smoke("mamba2-370m"),
                                 d_model=128, vocab=1000, mamba_d_state=128,
                                 mamba_head_dim=64,
                                 compute_dtype="bfloat16"),
    # A mixture of experts (16 experts, top-4, capacity routing) and the
    # jamba hybrid (Mamba heads of 64 with d_state 16, attention at
    # position 4, MoE every other layer), bf16.
    "moe": dataclasses.replace(configs.get_smoke("dbrx-132b"), d_model=256,
                               d_ff=128, vocab=1000, n_experts=16, top_k=4,
                               moe_impl="capacity", compute_dtype="bfloat16"),
    "jamba": dataclasses.replace(configs.get_smoke("jamba-v0.1-52b"),
                                 d_model=256, d_ff=128, vocab=1000,
                                 mamba_d_state=16, mamba_head_dim=64,
                                 moe_impl="capacity",
                                 compute_dtype="bfloat16"),
}


def _graph_engines(device, arch, paged, temperature=0.8):
    cfg = GRAPH_CFGS[arch]
    params = T.init_params(cfg, torch.Generator(device=device).manual_seed(0),
                           device=device)
    scfg = ServeConfig(max_len=512, batch=4, paged=paged, page_size=16,
                       chunk_size=64 if paged else None, eos_id=-1,
                       temperature=temperature, seed=1)
    return cfg, [ServingEngine(params, cfg, scfg, device=device,
                               capture=capture) for capture in (False, True)]


def _cache_tensors(eng):
    return [t for c in eng.caches for name, t in sorted(c.items())
            if name not in ("index", "pages")]


@pytest.mark.parametrize("arch,paged", [("attn", True), ("attn", False),
                                        ("mamba", False)],
                         ids=["paged", "contiguous", "mamba"])
def test_cuda_graphed_steps_match_eager_steps(cuda_device, arch, paged):
    """Three steps with changing inputs through an eager engine and a
    graphed one: the same ids and the same pool (or cache and state)
    contents, bit for bit; each replay adds its captured launches to
    ``ops.LAUNCHES``; the decodes' merge counters read zero after."""
    cfg, (eager, graphed) = _graph_engines(cuda_device, arch, paged)
    assert graphed.graphed and not eager.graphed
    assert graphed.graph_bytes > 0 == eager.graph_bytes
    # Builds are counted at a step's first use, captured or not.
    assert graphed.decode_traces == eager.decode_traces == 0
    kernel = {("attn", True): "flash_decode_paged",
              ("attn", False): "flash_decode"}.get((arch, paged))
    assert graphed._decode.launches == graphed._decode.nodes == (
        {kernel: cfg.n_layers} if kernel else {})
    if paged:
        assert graphed._chunk.launches == graphed._chunk.nodes == {
            "flash_attention_paged": cfg.n_layers}
        assert graphed.prefill_traces == eager.prefill_traces == {}
    rng = np.random.RandomState(0)
    b = graphed.scfg.batch
    table = rng.permutation(np.arange(1, 1 + b * 32)).reshape(b, 32)
    for step in range(3):
        index = rng.randint(0, 400, size=b).astype(np.int32)
        last = rng.randint(0, cfg.vocab, size=b)
        chunk = rng.randint(0, cfg.vocab, size=(1, 64))
        outs = []
        for eng in (eager, graphed):
            eng.slots = [Request(rid=step - i, prompt=np.zeros(1, np.int32),
                                 max_new=9, generated=[0] * (step + i))
                         for i in range(b)]
            if paged:
                eng.pages[:] = table
            eng.index[:] = index
            eng.last_tok[:] = last
            ops.reset_launches()
            got = []
            if paged:
                tok = eng._chunk_step(chunk, int(index[0]), 0, 63 - step,
                                      eng.slots[0])
                got.append(int(tok))
            got.append(eng._decode_step(list(range(b))).tolist())
            torch.cuda.synchronize()
            assert ops.LAUNCHES == dict(
                dict.fromkeys(ops.LAUNCHES, 0),
                **{k: v for s in (graphed._chunk if paged else None,
                                  graphed._decode) if s
                   for k, v in s.launches.items()})
            outs.append(got)
        assert outs[0] == outs[1], step
        for a, g in zip(_cache_tensors(eager), _cache_tensors(graphed)):
            assert torch.equal(a, g), step
    assert graphed.decode_traces == eager.decode_traces == 1
    assert graphed.prefill_traces == eager.prefill_traces == (
        {64: 1} if paged else {})
    assert all(int(t.count_nonzero()) == 0
               for t in flash_decode._COUNTERS.values())


def _one_launch_each(device, dtype):
    """One call of each wrapper at small shapes, keyed by its
    ``ops.LAUNCHES`` name: the kernel it launches in ``dtype``."""
    g = torch.Generator(device=device).manual_seed(5)
    mk = lambda *s: torch.randn(*s, generator=g, device=device).to(dtype)  # noqa
    b, h, kvh, d, ps, n_pages = 2, 8, 2, 64, 16, 9
    kp, vp = mk(n_pages, ps, kvh, d), mk(n_pages, ps, kvh, d)
    table = torch.arange(1, 9, dtype=torch.int32, device=device).view(2, 4)
    ints = dict(dtype=torch.int32, device=device)
    lengths, starts = torch.tensor([5, 40], **ints), torch.tensor([0, 16], **ints)
    k, v = mk(b, 64, kvh, d), mk(b, 64, kvh, d)
    x = mk(1, 256, 4, 64)
    a = -torch.rand(1, 256, 4, device=device) * 0.1
    bm, cm = mk(1, 256, 128), mk(1, 256, 128)
    chain = torch.roll(torch.arange(64, **ints), 1)
    q1, qc, qs = mk(b, h, d), mk(b, 16, h, d), mk(b, 64, h, d)
    gx, gy = mk(64, 128), mk(128, 64)
    return {
        "flash_decode_paged": lambda: ops.flash_decode_paged(
            q1, kp, vp, table, lengths),
        "flash_attention_paged": lambda: ops.flash_attention_paged(
            qc, kp, vp, table, starts),
        "flash_decode": lambda: ops.flash_decode(q1, k, v, lengths),
        "flash_attention": lambda: ops.flash_attention(qs, k, v),
        "ssd_scan": lambda: ops.ssd_scan(x, a, bm, cm),
        "gemm": lambda: ops.gemm(gx, gy),
        "pchase": lambda: ops.pchase(chain, 100),
    }


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_graph_nodes_name_each_wrappers_kernel(cuda_device, dtype):
    """Each wrapper's call captured alone: the graph's kernel nodes, read
    back from the driver, hold its kernel once and no other of the
    port's (the names ``graphs.KERNELS`` maps, in both dtypes)."""
    for name, call in _one_launch_each(cuda_device, dtype).items():
        step = graphs.Step(call, cuda_device, capture=True)
        assert step.nodes == step.launches == {name: 1}, (
            name, graphs.kernel_names(step.graph.raw_cuda_graph()))
        ops.reset_launches()
        step()
        step()
        torch.cuda.synchronize()
        assert ops.LAUNCHES == dict(dict.fromkeys(ops.LAUNCHES, 0),
                                    **{name: 2})


@pytest.mark.parametrize("paged", [True, False])
def test_cuda_graph_replays_hold_peak_memory_flat(cuda_device, paged):
    _, (_, graphed) = _graph_engines(cuda_device, "attn", paged)
    graphed.slots = [Request(rid=i, prompt=np.zeros(1, np.int32), max_new=9)
                     for i in range(graphed.scfg.batch)]
    peaks = []
    for step in range(4):
        graphed.index[:] = 10 * step
        graphed._decode_step(list(range(graphed.scfg.batch)))
        torch.cuda.synchronize()
        peaks.append(torch.cuda.max_memory_allocated(cuda_device))
    assert peaks[1] == peaks[2] == peaks[3], peaks


@pytest.mark.parametrize("arch,paged", [("attn", True), ("attn", False),
                                        ("mamba", False)],
                         ids=["paged", "contiguous", "mamba"])
@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_cuda_graphed_engines_serve_the_eager_streams(cuda_device, arch,
                                                      paged, temperature):
    """Whole runs, eager against graphed: the same streams, ticks, steps
    and launches."""
    cfg, engines = _graph_engines(cuda_device, arch, paged, temperature)
    rng = np.random.RandomState(1)
    prompts = [rng.randint(2, cfg.vocab, size=n).astype(np.int32)
               for n in (5, 70, 130, 9, 200, 33)]
    runs = []
    for eng in engines:
        for rid, p in enumerate(prompts):
            eng.submit(Request(rid=rid, prompt=p, max_new=12))
        ops.reset_launches()
        streams = eng.run_until_drained()
        torch.cuda.synchronize()
        runs.append((streams, eng.ticks, eng.chunk_steps, eng.decode_steps,
                     dict(eng.prefill_buckets), dict(ops.LAUNCHES),
                     eng.decode_traces, dict(eng.prefill_traces)))
    assert runs[0] == runs[1]


@pytest.mark.parametrize("arch,paged", [("moe", True), ("jamba", False)])
def test_cuda_graphed_families_serve_the_eager_streams(cuda_device, arch,
                                                       paged):
    """A mixture of experts on the paged engine and the jamba hybrid on
    the contiguous one: the capacity routing runs inside the captured
    decode (and chunk) graphs without waiting on the host, and graphed
    runs give the eager streams, ticks, steps and launches."""
    cfg, engines = _graph_engines(cuda_device, arch, paged, 0.0)
    rng = np.random.RandomState(1)
    prompts = [rng.randint(2, cfg.vocab, size=n).astype(np.int32)
               for n in (5, 70, 130, 9, 200, 33)]
    runs = []
    for eng in engines:
        for rid, p in enumerate(prompts):
            eng.submit(Request(rid=rid, prompt=p, max_new=12))
        ops.reset_launches()
        streams = eng.run_until_drained()
        torch.cuda.synchronize()
        runs.append((streams, eng.ticks, eng.chunk_steps, eng.decode_steps,
                     dict(eng.prefill_buckets), dict(ops.LAUNCHES)))
    assert runs[0] == runs[1]
    n_attn = T.n_attention_layers(cfg)
    want = ({"flash_decode_paged": n_attn} if paged
            else {"flash_decode": n_attn})
    assert engines[1].graph_nodes["decode"] == want
    if not paged:
        admissions = sum(engines[1].prefill_buckets.values())
        assert runs[1][5]["ssd_scan"] == (cfg.n_layers - n_attn) * admissions


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_cuda_graphed_spec_engine_with_prefix_cache_serves_the_eager_streams(
        cuda_device, temperature):
    """Speculative decoding (spec_k 2) with the prefix cache, eager
    against graphed: the verify graph holds one paged prefill a layer and
    no decode; the same streams, ticks, counters and launches; cached
    streams equal uncached ones."""
    cfg = GRAPH_CFGS["attn"]
    params = T.init_params(cfg, torch.Generator(device=cuda_device)
                           .manual_seed(0), device=cuda_device)
    rng = np.random.RandomState(2)
    shared = rng.randint(2, cfg.vocab, 128)
    prompts = [np.concatenate([shared, rng.randint(2, cfg.vocab, n)])
               .astype(np.int32) for n in (5, 70, 30, 9, 64, 33)]
    runs = []
    for capture, cache in ((False, True), (True, True), (True, False)):
        eng = ServingEngine(params, cfg, ServeConfig(
            max_len=512, batch=4, paged=True, page_size=16, chunk_size=64,
            eos_id=-1, temperature=temperature, seed=1, spec_k=2,
            prefix_cache=cache), device=cuda_device, capture=capture)
        if capture:
            assert eng.graph_nodes["verify"] == {
                "flash_attention_paged": cfg.n_layers}
            assert "decode" not in eng.graph_nodes
        for rid, p in enumerate(prompts):
            eng.submit(Request(rid=rid, prompt=p, max_new=12))
        ops.reset_launches()
        streams = eng.run_until_drained()
        torch.cuda.synchronize()
        assert ops.LAUNCHES["flash_decode_paged"] == 0
        assert ops.LAUNCHES["flash_attention_paged"] == cfg.n_layers * (
            eng.chunk_steps + eng.verify_steps)
        runs.append((streams, eng.ticks, eng.chunk_steps, eng.verify_steps,
                     eng.spec_accepted, eng.spec_emitted, eng.prefix_hits,
                     eng.prefix_hit_pages, dict(ops.LAUNCHES)))
    assert runs[0] == runs[1]
    assert runs[1][0] == runs[2][0] and runs[1][6] > 0


def test_cuda_degrading_spec_engine_replays_both_graphs_under_faults(
        cuda_device):
    """A speculative engine with ``degrade`` holds a verify graph and a
    decode graph; open-loop bursty traffic of two classes under the
    canonical fault schedule runs both (verify ticks, and plain decode
    ticks while degraded), eager and graphed alike: the same event trace,
    outcomes, streams and launches, every request resolved, no page
    leaked."""
    cfg = GRAPH_CFGS["attn"]
    n = cfg.n_layers
    params = T.init_params(cfg, torch.Generator(device=cuda_device)
                           .manual_seed(0), device=cuda_device)
    scfg = ServeConfig(max_len=512, batch=4, paged=True, page_size=16,
                       chunk_size=64, eos_id=-1, n_pages=49, spec_k=2,
                       degrade=True, max_queue=8, max_preemptions=3,
                       prefill_chunks_per_tick=2, trace_capacity=1 << 16,
                       classes=(SLOClass("chat", priority=2),
                                SLOClass("batch", rate=64.0)))
    tcfg = traffic.TrafficConfig(
        rate=0.5, n_requests=24, seed=0, process="bursty", vocab=cfg.vocab,
        max_prompt=300, classes=(
            traffic.TrafficClass("chat", weight=0.7, prompt_lo=16,
                                 prompt_hi=128, out_lo=8, out_hi=24),
            traffic.TrafficClass("batch", weight=0.3, prompt_lo=128,
                                 prompt_hi=300, out_lo=8, out_hi=24)))
    runs = []
    for capture in (False, True):
        eng = ServingEngine(params, cfg, scfg, device=cuda_device,
                            capture=capture)
        if capture:
            assert eng.graph_nodes == {
                "verify": {"flash_attention_paged": n},
                "decode": {"flash_decode_paged": n},
                "chunk": {"flash_attention_paged": n}}
        inj = FaultInjector(canonical_schedule())
        ops.reset_launches()
        res = traffic.run_open_loop(eng, traffic.TrafficGenerator(tcfg)
                                    .arrivals(), injector=inj)
        inj.finish(eng)
        torch.cuda.synchronize()
        assert res["unresolved"] == [] and eng.pool.pages_in_use == 0
        assert inj.injected == inj.cleared == 3
        assert eng.decode_steps > 0 and eng.verify_steps > 0
        assert eng.downshifts >= 1 and eng.preemptions >= 1
        assert ops.LAUNCHES["flash_decode_paged"] == n * eng.decode_steps
        assert ops.LAUNCHES["flash_attention_paged"] == n * (
            eng.chunk_steps + eng.verify_steps)
        runs.append(([e[1:] for e in eng.telemetry.events], eng.outcome,
                     eng.finished, eng.ticks, dict(eng.telemetry.counters),
                     dict(ops.LAUNCHES), eng.decode_traces,
                     eng.verify_traces))
    assert runs[0] == runs[1]


def test_cuda_keys_and_bits_match_the_cpu(cuda_device):
    rids = torch.tensor([0, 1, -1, -2**31, 2**31 - 1, 12345])
    ts = torch.tensor([0, 2**31 - 1, 7, 1, 2**31 - 2, 31])
    base = sampling.prng_key(0)
    cpu = sampling.fold_row_keys(base, rids, ts)
    card = sampling.fold_row_keys(base.to(cuda_device), rids.to(cuda_device),
                                  ts.to(cuda_device))
    assert torch.equal(card.cpu(), cpu)
    bits = sampling.random_bits(cpu, (151936,))
    assert torch.equal(sampling.random_bits(card, (151936,)).cpu(), bits)
    u = sampling.uniform(cpu, (151936,))
    assert torch.equal(sampling.uniform(card, (151936,)).cpu(), u)


def test_cuda_calibration_probes_launch_the_decode_kernels(cuda_device,
                                                           tmp_path,
                                                           monkeypatch):
    """The page-lookup probe times both decode kernels on the card (device
    time, both launched), the stream reads no faster than the data sheet,
    and every constant is finite and positive and persists under
    ``calibrated:cuda:...`` of a tmp cache."""
    from repro_torch.core import autotune, calibrate, hwmodel

    monkeypatch.setattr(autotune, "TUNING_CACHE_PATH",
                        str(tmp_path / "cache.json"))
    monkeypatch.setattr(autotune, "_tuning_cache", None)
    monkeypatch.delenv(autotune.DEFAULT_CONSTANTS_ENV, raising=False)
    results = calibrate.run_calibration(fast=True, device=cuda_device)
    assert set(results) == set(autotune.CALIBRATED_NAMES)
    for name, r in results.items():
        assert np.isfinite(r.value) and r.value > 0, name
    lookup = results["page_lookup_s"].detail
    assert lookup["timing"] == "device"
    assert min(lookup["launches"].values()) > 0
    assert results["hbm_bandwidth"].value <= hwmodel.H100.hbm_bandwidth
    assert results["chunk_dispatch_s"].detail["graphed"]
    const = autotune.resolve_constants(backend="cuda")
    assert const.source == "calibrated" and const.backend == "cuda"


def test_cuda_adaptive_spec_engine_graphed_equals_eager(cuda_device):
    """An adaptive speculative engine (``spec_adapt_every`` and
    ``spec_probe_every``) holds both the verify and the decode graph, and
    serves through an accept collapse as its eager twin does: the same
    streams, ``k_live`` a tick, trial ticks, event trace and launches."""
    from repro_torch.serve.faults import Fault

    cfg = GRAPH_CFGS["attn"]
    n = cfg.n_layers
    params = T.init_params(cfg, torch.Generator(device=cuda_device)
                           .manual_seed(0), device=cuda_device)
    scfg = ServeConfig(max_len=512, batch=4, paged=True, page_size=16,
                       chunk_size=64, eos_id=-1, spec_k=3,
                       spec_adapt_every=2, spec_probe_every=2,
                       trace_capacity=1 << 16)
    rng = np.random.RandomState(3)
    prompts = [rng.randint(2, cfg.vocab, size=m).astype(np.int32)
               for m in (40, 90, 17, 150, 64)]
    runs = []
    for capture in (False, True):
        eng = ServingEngine(params, cfg, scfg, device=cuda_device,
                            capture=capture)
        if capture:
            assert eng.graph_nodes == {
                "verify": {"flash_attention_paged": n},
                "decode": {"flash_decode_paged": n},
                "chunk": {"flash_attention_paged": n}}
        for rid, p in enumerate(prompts):
            eng.submit(Request(rid=rid, prompt=p, max_new=40))
        inj = FaultInjector([Fault(kind=FaultInjector.ACCEPT_COLLAPSE,
                                   start=6, stop=14)])
        ops.reset_launches()
        traj = []
        for _ in range(1000):
            inj.step(eng)
            eng.tick()
            traj.append(eng.k_live)
            if not eng.queue and all(s is None for s in eng.slots):
                break
        inj.finish(eng)
        torch.cuda.synchronize()
        assert eng.pool.pages_in_use == 0 and len(eng.finished) == 5
        runs.append((eng.finished, traj, eng.spec_probes,
                     [e[1:] for e in eng.telemetry.events],
                     dict(ops.LAUNCHES), eng.decode_traces,
                     eng.verify_traces))
    assert runs[0] == runs[1]
    assert 0 in runs[1][1]


# ----------------------------------------------------------------------------
# Tensor-parallel serving on the card (two gloo ranks sharing it)
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_contiguous_decode_on_the_gathered_view(cuda_device, dtype):
    """The contiguous decode at the shape a rank of a two-rank qwen3-4b
    mesh hands it: the view ``serve.dist.gather_pages`` assembled (b 4 x
    512 rows of 8 kv heads of 80), cut to the rank's 4 kv heads as
    ``layers._local_kv_heads`` cuts it, with the rank's 16 q heads."""
    from repro_torch.models import layers

    g = torch.Generator(device=cuda_device).manual_seed(23)
    mk = lambda *s: torch.randn(*s, generator=g, device=cuda_device,   # noqa
                                dtype=torch.float32).to(dtype)
    ck, cv = mk(4, 512, 8, 80), mk(4, 512, 8, 80)
    lengths = torch.tensor([108, 211, 330, 408], dtype=torch.int32,
                           device=cuda_device)
    for rank in (0, 1):
        k, v = layers._local_kv_heads(ck, cv, 32, 16, rank)
        assert k.shape == (4, 512, 4, 80) and k.is_contiguous()
        q = mk(4, 16, 80)
        ops.reset_launches()
        got = ops.flash_decode(q, k, v, lengths)
        torch.cuda.synchronize()
        ok, err = ref.compare(got, ref.flash_decode(q, k, v, lengths))
        assert ok, err
        assert ops.LAUNCHES["flash_decode"] == 1


def _two_rank_logits(rank, world):
    """A rank of the two-rank check: the qwen3-4b smoke config on the
    card at head_dim 64 (a width the decode kernel builds), fp32, a
    24-row prefill and a decode step through the sharded pool (its table
    spanning both ranks); rank 0 also runs one rank."""
    from repro_torch.dist import sharding
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.serve import dist as serve_dist
    from repro_torch.serve import paged

    dev = mesh_lib.rank_device(rank, "cuda")
    torch.cuda.set_device(dev)
    mesh = mesh_lib.make_serving_mesh(world)
    rules = serve_dist.serve_ruleset(mesh)
    cfg = dataclasses.replace(configs.get_smoke("qwen3-4b"), head_dim=64)
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    pool = paged.PageAllocator(16, 8, n_devices=world)
    table = np.zeros((2, 8), np.int32)
    for i in range(2):
        got = pool.alloc(i, 4)
        table[i, :4] = got
    toks = torch.from_numpy(np.random.RandomState(0).randint(
        2, cfg.vocab, size=(2, 25))).to(dev)

    def run(p, rs, shard):
        caches = T.init_paged_caches(cfg, 2, 64, 8, 16, device=dev)
        caches[0]["pages"].copy_(torch.from_numpy(table))
        if shard:
            caches = serve_dist.shard_caches(caches, mesh)
        with torch.no_grad(), sharding.use_ruleset(rs):
            pre, caches = T.forward(p, cfg, toks[:, :-1], caches=caches)
            step, _ = T.forward(p, cfg, toks[:, -1:], caches=caches)
        # numpy: a tensor through the result queue would be shared memory
        # that dies with this process.
        return pre.cpu().numpy(), step.cpu().numpy()

    ops.reset_launches()
    two = run(serve_dist.shard_params(params, mesh, rules), rules, True)
    launched = ops.LAUNCHES["flash_decode"]
    one = run(params, None, False) if rank == 0 else None
    spans = [sorted({pool.device_of(p) for p in pool.slot_pages[i]})
             for i in range(2)]
    return two, one, launched, spans


def test_cuda_two_rank_engine_logits_match_one_rank(cuda_device):
    """Two gloo ranks sharing the card: the fp32 logits of a prefill and
    a decode step through the sharded pool within 1e-3 of one rank's
    (the row-parallel sums reorder fp32 additions), the decode step's
    ``flash_decode`` launched once a layer on each rank."""
    from repro_torch.launch import mesh as mesh_lib

    ranks = mesh_lib.run_ranks(_two_rank_logits, 2, deadline_s=240.0,
                               timeout_s=120.0)
    (two_pre, two_step), (one_pre, one_step), _, spans = ranks[0]
    assert all(len(s) == 2 for s in spans)
    assert float(np.abs(two_pre - one_pre).max()) <= 1e-3
    assert float(np.abs(two_step - one_step).max()) <= 1e-3
    n_layers = configs.get_smoke("qwen3-4b").n_layers
    assert [r[2] for r in ranks] == [n_layers, n_layers]
    assert np.array_equal(ranks[1][0][1], two_step)


def test_cuda_paged_writes_keep_the_last_write(cuda_device):
    """``serve.paged.write_rows`` on the card: 64 writes a pool row (the
    null page's collisions), each row holding the last write's values in
    every one of 20 repetitions (a plain duplicate-index assignment
    leaves the winner to the card's threads)."""
    from repro_torch.serve import paged

    g = torch.Generator(device=cuda_device).manual_seed(0)
    n, ps = 4096, 16
    page = torch.zeros((n // 64, 64), dtype=torch.int64, device=cuda_device)
    row = torch.arange(n, device=cuda_device).reshape(n // 64, 64) % ps
    k = torch.randn(n // 64, 64, 8, 128, generator=g, device=cuda_device)
    flat_k = k.reshape(n, 8, 128)
    want = torch.stack([flat_k[n - ps + r] for r in range(ps)])
    for _ in range(20):
        kp = torch.zeros((2, ps, 8, 128), device=cuda_device)
        vp = torch.zeros_like(kp)
        paged.write_rows(kp, vp, k, k, page, row)
        assert torch.equal(kp[0], want) and torch.equal(vp[0], want)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_int8_cache_writes_saturate(cuda_device, dtype):
    """``layers.cast_to`` and the contiguous write (``layers._write_rows``)
    into an int8 cache on the card give the CPU's values: NaN to 0, the
    int8 bounds past them, truncation toward zero inside (bf16 rounds
    127.9 to 128 first), as the reference's ``astype(int8)`` does."""
    from repro_torch.models import layers

    g = torch.Generator().manual_seed(0)
    x = torch.randn(4096, generator=g) * 200
    x[:5] = torch.tensor([300.0, -300.0, 127.9, -127.9, float("nan")])
    x = x.to(dtype)
    want = layers.cast_to(x, torch.int8)
    if dtype == torch.bfloat16:
        assert want[:5].tolist() == [127, -128, 127, -128, 0]
    assert torch.equal(layers.cast_to(x.to(cuda_device), torch.int8).cpu(),
                       want)
    k = x.reshape(1, 2, 32, 64).to(cuda_device)
    ck = torch.zeros((1, 4, 32, 64), dtype=torch.int8, device=cuda_device)
    cv = torch.zeros_like(ck)
    layers._write_rows(ck, cv, k, -k, torch.tensor([[1, 2]],
                                                   device=cuda_device))
    assert torch.equal(ck[0, 1:3].cpu().reshape(-1), want)
    assert torch.equal(cv[0, 1:3].cpu().reshape(-1),
                       layers.cast_to(-x, torch.int8))


def test_cuda_flash_decode_reads_an_int8_cache_cast_to_bf16(cuda_device):
    """qwen3-4b's decode shape (b 8, 32/8 heads of 80) against an int8
    cache of small integers (a qk-normed K rounds so) cast to bf16, as
    the cached forward casts it: the kernel within ``ref.TOLERANCE`` of
    its plain version; and the qwen3-4b smoke (at head_dim 64, a width
    the kernel is built for) in fp32, a prefill and a decode step against
    int8 caches on the card within 1e-4 of the CPU's logits (in bf16 one
    element truncated across an integer apart moves them far more than
    the arithmetic does)."""
    g = torch.Generator(device=cuda_device).manual_seed(1)
    b, h, kvh, d, rows = 8, 32, 8, 80, 2048
    kc, vc = (torch.randint(-4, 5, (b, rows, kvh, d), generator=g,
                            device=cuda_device, dtype=torch.int8)
              for _ in range(2))
    q = torch.randn(b, h, d, generator=g, device=cuda_device).bfloat16()
    lens = torch.tensor([1, 2, 255, 256, 700, 1500, rows - 1, rows],
                        dtype=torch.int32, device=cuda_device)
    k, v = kc.bfloat16(), vc.bfloat16()
    ops.reset_launches()
    ok, err = ref.compare(ops.flash_decode(q, k, v, lens),
                          ref.flash_decode(q, k, v, lens))
    assert ok, err
    assert ops.LAUNCHES["flash_decode"] == 1
    cfg = dataclasses.replace(configs.get_smoke("qwen3-4b"), head_dim=64)
    params = T.init_params(cfg, device="cpu")
    prompt = torch.arange(2, 14).reshape(2, 6)
    logits = {}
    for dev in ("cpu", cuda_device):
        p = tree_map(lambda t: t.to(dev), params)
        caches = T.init_caches(cfg, 2, 16, device=dev, dtype=torch.int8)
        with torch.no_grad():
            _, caches = T.forward(p, cfg, prompt.to(dev), caches=caches)
            out, _ = T.forward(p, cfg, prompt[:, -1:].to(dev), caches=caches)
        logits[str(dev)] = out.float().cpu()
    scale = float(logits["cpu"].abs().max())
    assert float((logits["cuda"] - logits["cpu"]).abs().max()) \
        <= 1e-4 * scale
