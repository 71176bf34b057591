"""The split decode of the PyTorch port on the CPU: the model of how the
CUDA decode cuts a slot's context (``ref.flash_decode_split``), the host
helper that sizes its grid (``kernels.flash_decode.splits``), the
wrappers' launch arguments, and the profiler's kernel families.

The model is held at 1e-6 in fp32 against the plain decodes and against
the reference's Pallas ``flash_decode`` and ``flash_decode_paged`` run in
interpret mode: each side sums the same fp32 softmax in another order.
Groups 1, 4 and 7; lengths 0 (every split empty), 1, a split boundary
and one row either side of it, the cache's reach, and past it (a drifting
free slot, clamped). The CUDA kernels themselves are held against the
plain versions in ``test_torch_cuda.py``, on a card.
"""

import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels import ops as jops

from repro_torch.kernels import _build, ref
from repro_torch.kernels import flash_decode as _decode
from repro_torch.launch import profile
from repro_torch.serve.paged import gather_kv

ATOL = 1e-6
KVH, D = 2, 16


def _lengths(max_rows: int, rows: int):
    """0, 1, each split boundary and one row either side, the reach, past
    it: one slot each."""
    out = {0, 1, max_rows, max_rows + 9}
    for edge in range(rows, max_rows, rows):
        out |= {edge - 1, edge, edge + 1}
    return np.asarray(sorted(out), np.int32)


@pytest.mark.parametrize("group", [1, 4, 7])
@pytest.mark.parametrize("max_len,rows", [(64, 16), (40, 16), (520, 256)])
def test_split_model_matches_contiguous_decodes(group, max_len, rows):
    """Contiguous (b, max_len, kvh, d): the split model against
    ``ref.flash_decode`` and the Pallas ``flash_decode`` (interpret)."""
    rng = np.random.RandomState(group * 31 + max_len + rows)
    lengths = _lengths(max_len, rows)
    b, h = len(lengths), KVH * group
    q = rng.randn(b, h, D).astype(np.float32)
    k = rng.randn(b, max_len, KVH, D).astype(np.float32)
    v = rng.randn(b, max_len, KVH, D).astype(np.float32)
    t = [torch.from_numpy(a) for a in (q, k, v, lengths)]
    got = ref.flash_decode_split(*t, rows).numpy()
    assert got.shape == (b, h, D) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref.flash_decode(*t).numpy(), atol=ATOL,
                               rtol=0)
    pallas = np.asarray(jops.flash_decode(*(jnp.asarray(a)
                                            for a in (q, k, v, lengths)),
                                          block_k=8))
    np.testing.assert_allclose(got, pallas, atol=ATOL, rtol=0)
    assert not got[lengths == 0].any()          # every split empty: zeros


@pytest.mark.parametrize("group", [1, 4, 7])
@pytest.mark.parametrize("ps,max_pages,rows", [(8, 8, 16), (8, 5, 24)])
def test_split_model_matches_paged_decodes(group, ps, max_pages, rows):
    """Through shuffled page tables: the split model over the gathered
    cache against ``ref.flash_decode_paged`` and the Pallas
    ``flash_decode_paged`` (interpret); splits of whole pages."""
    rng = np.random.RandomState(group * 17 + max_pages)
    max_rows = max_pages * ps
    lengths = _lengths(max_rows, rows)
    b, h = len(lengths), KVH * group
    n_pages = 1 + b * max_pages
    kp = rng.randn(n_pages, ps, KVH, D).astype(np.float32)
    vp = rng.randn(n_pages, ps, KVH, D).astype(np.float32)
    table = (rng.permutation(n_pages - 1) + 1).reshape(b, max_pages)
    table = table.astype(np.int32)
    q = rng.randn(b, h, D).astype(np.float32)
    tq, tk, tv, tt, tl = (torch.from_numpy(a)
                          for a in (q, kp, vp, table, lengths))
    kc, vc = gather_kv(tk, tv, tt)
    got = ref.flash_decode_split(tq, kc, vc, tl, rows).numpy()
    np.testing.assert_allclose(
        got, ref.flash_decode_paged(tq, tk, tv, tt, tl).numpy(), atol=ATOL,
        rtol=0)
    pallas = np.asarray(jops.flash_decode_paged(
        *(jnp.asarray(a) for a in (q, kp, vp, table, lengths))))
    np.testing.assert_allclose(got, pallas, atol=ATOL, rtol=0)
    assert not got[lengths == 0].any()


@pytest.mark.parametrize("max_rows,page_size,want", [
    (2048, 16, (256, 8)),       # the main path: qwen3-4b, max_len 2048
    (2048, 1, (256, 8)),        # contiguous
    (1024, 16, (256, 4)),
    (64, 8, (256, 1)),
    (0, 16, (256, 1)),          # a table of no pages: one empty split
    (2048, 3, (255, 9)),        # splits of whole pages
    (100, 512, (512, 1)),       # a page larger than a split
    (10**6, 16, (256, 3907)),   # long contexts: more splits, same rows
])
def test_splits_are_sized_from_shapes(max_rows, page_size, want):
    rows, n = _decode.splits(max_rows, page_size)
    assert (rows, n) == want
    assert rows % page_size == 0 and 1 <= n <= 65535   # the grid's z
    assert n * rows >= max_rows                 # the splits cover the reach
    assert max_rows == 0 or (n - 1) * rows < max_rows   # none past it


class _FakeLib:
    """Records the arguments of each C entry point instead of launching."""

    def __init__(self):
        self.calls = {}

    def __getattr__(self, name):
        def call(*args):
            assert len(args) == len(_build.SIGNATURES[name]), name
            self.calls[name] = args
            return 0
        return call


@pytest.fixture
def fake_launch(monkeypatch):
    """The wrappers' launches recorded on the CPU instead of run."""
    lib = _FakeLib()
    monkeypatch.setattr(_build, "load", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 0}))
    return lib


def _no_host_reads(monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("the decode wrapper read a tensor on the host")
    for name in ("item", "tolist", "cpu", "numpy", "__int__", "__index__",
                 "__bool__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)


@pytest.mark.parametrize("lengths", [[0, 0], [5, 900], [4096, 1]])
def test_decode_grid_depends_on_shapes_alone(fake_launch, monkeypatch,
                                             lengths):
    """Both wrappers pass (rows_per_split, n_splits) from ``splits`` of the
    cache's shape, whatever the lengths, and read none of them."""
    b, h, d, ps, max_pages, max_len = 2, 8, 80, 16, 64, 2048
    q = torch.zeros(b, h, d)
    pool = torch.zeros(3, ps, 2, d)
    table = torch.zeros(b, max_pages, dtype=torch.int32)
    cache = torch.zeros(b, max_len, 2, d)
    lens = torch.tensor(lengths, dtype=torch.int32)
    out = torch.empty_like(q)
    _no_host_reads(monkeypatch)
    _decode.paged_decode(q, pool, pool, table, lens, out)
    _decode.contiguous_decode(q, cache, cache, lens, out)
    monkeypatch.undo()
    paged = fake_launch.calls["paged_decode"]
    assert paged[-3:-1] == _decode.splits(max_pages * ps, ps) == (256, 4)
    contiguous = fake_launch.calls["contiguous_decode"]
    assert contiguous[-3:-1] == _decode.splits(max_len) == (256, 8)


def test_scratch_is_sized_from_shapes(monkeypatch):
    """The partials: b * h * n_splits * (d + 2) floats a call. The merge's
    counters: b * h zeroed ints kept per (device, stream), grown when a
    larger batch comes, shared by the launches of one stream."""
    monkeypatch.setattr(_decode, "_COUNTERS", {})
    q = torch.zeros(3, 8, 80)
    part = _decode._partials(q, 8)
    assert part.dtype == torch.float32 and part.numel() == 3 * 8 * 8 * 82
    counters = _decode._counters(q, 7)
    assert counters.dtype == torch.int32 and counters.numel() == 24
    assert not counters.any()
    assert _decode._counters(q[:2], 7) is counters
    assert _decode._counters(q, 9) is not counters      # another stream
    assert _decode._counters(torch.zeros(4, 8, 80), 7).numel() == 32


# Every __global__ kernel in csrc/, with the template arguments of one of
# its instantiations (the layout varied where it is a parameter), and the
# family launch/profile.py must file it under.
KERNEL_FAMILIES = {
    ("decode_split_kernel", "PagedLayout"): "flash_decode_paged",
    ("decode_split_kernel", "ContiguousLayout"): "flash_decode",
    ("prefill_kernel", "PagedLayout"): "flash_attention_paged",
    ("prefill_kernel", "ContiguousLayout"): "flash_attention",
    ("prefill_mma_kernel", "PagedLayout"): "flash_attention_paged",
    ("prefill_mma_kernel", "ContiguousLayout"): "flash_attention",
    ("ssd_scan_kernel", None): "ssd_scan",
    ("ssd_scan_mma_kernel", None): "ssd_scan",
    ("gemm_kernel", None): "gemm",
    ("gemm_wgmma_kernel", None): "gemm",
    ("pchase_kernel", None): "pchase",
    ("pchase_timed_kernel", None): "pchase_timed",
}
GLOBAL = re.compile(r"(?:template\s*<([^>]*)>\s*)?__global__\s+void\s+"
                    r"(?:__launch_bounds__\((?:[^()]|\([^()]*\))*\)\s*)?"
                    r"(\w+)\s*\(", re.S)
ARG = {"typename T": "__nv_bfloat16", "int D": "80", "int G": "16",
       "int P": "64", "int N": "128", "int BM": "128", "int BN": "128",
       "int BQ": "16", "int CHUNK": "64",
       "bool kVec": "true", "bool kTma": "true", "bool kBypassL1": "true"}


def _demangled(name, params, layout):
    """The name CUPTI reports for an instantiation of the kernel."""
    if params is None:
        return f"(anonymous namespace)::{name}(int const*, int*, int)"
    args = [f"(anonymous namespace)::{layout}" if p.strip() ==
            "typename Layout" else ARG[p.strip()] for p in params.split(",")]
    return (f"void (anonymous namespace)::{name}<{', '.join(args)}>"
            f"(float const*, float*)")


def test_profile_families_key_each_port_kernel_on_its_own_name():
    found = set()
    for src in _build.sources():
        for params, name in GLOBAL.findall(src.read_text()):
            layouts = (("PagedLayout", "ContiguousLayout")
                       if "typename Layout" in params else (None,))
            for layout in layouts:
                found.add((name, layout))
                fam = profile.family(_demangled(name, params or None,
                                                layout))
                assert fam == KERNEL_FAMILIES.get((name, layout)), \
                    (name, layout, fam)
    assert found == set(KERNEL_FAMILIES)
    for lib_name in ("nvjet_tst_128x8_64x12_4x1_v_bz_NNT",
                     "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n"):
        assert profile.family(lib_name) == "GEMM (cuBLAS)"
