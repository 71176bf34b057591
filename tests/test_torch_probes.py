"""The paper's probes in the PyTorch port against the reference: the
pointer chase, the blocked GEMM, the §4.1 latency model and the GEMM tile
chooser.

On the CPU the port's wrappers route to their plain versions
(``repro_torch.kernels.ref``); those are held against the reference's
Pallas kernels in interpret mode (``repro.kernels``). The CUDA kernels
themselves are held against the plain versions in ``test_torch_cuda.py``,
on a card. Inputs are made with numpy from fixed seeds and handed to both.

Tolerances: the chase is bit-equal. The GEMM keeps the reference test's
own (``tests/test_kernels.py::test_gemm_sweep``): rtol 1e-4 and atol 1e-4 k
in fp32, 2e-2 and 2e-2 k in bf16: both sides sum in fp32 in another order
and round once, so bf16 outputs may sit one rounding step apart. The
latency model is pure Python and gives the reference's answers exactly.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core import autotune as jautotune
from repro.core import hwmodel as jhwmodel
from repro.core import latency as jlatency
from repro.kernels import ops as jops
from repro.kernels.gemm import gemm as jgemm_raw

from repro_torch.core import autotune, hwmodel, latency
from repro_torch.kernels import ops
from repro_torch.kernels.gemm import TILES
from repro_torch.launch import autotune_gemm as autotune_launch
from repro_torch.launch import latency as latency_launch

JDTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _perm_chain(n, seed):
    """The chain of ``tests/test_kernels.py::test_pchase_kernel_follows_chain``
    at n = 128, seed 4: one random cycle through all n positions."""
    rng = np.random.RandomState(seed)
    perm = rng.permutation(n).astype(np.int32)
    chain = np.empty(n, np.int32)
    chain[perm] = np.roll(perm, -1)
    return chain


CHAINS = {
    "permutation": (_perm_chain(128, 4), 64),
    "steps_past_n": (_perm_chain(128, 4), 300),
    "one_step": (_perm_chain(128, 4), 1),
    "strided": ((np.arange(256) + 32) % 256, 40),
    "self_loop": (np.zeros(8, np.int32), 5),
}


@pytest.mark.parametrize("case", sorted(CHAINS))
def test_pchase_matches_reference(case):
    chain, steps = CHAINS[case]
    chain = chain.astype(np.int32)
    want = np.asarray(jops.pchase(jnp.asarray(chain), steps))
    got = ops.pchase(torch.from_numpy(chain), steps)
    assert got.dtype == torch.int32 and got.shape == (steps,)
    np.testing.assert_array_equal(got.numpy(), want)


def test_line_chain_is_one_cycle_through_every_line():
    """``line_chain`` visits every line's first word once before it comes
    back to position 0, and keeps every entry inside the chain."""
    fp = 64 * 1024
    chain = latency.line_chain(fp, seed=3, device="cpu")
    words, n_lines = latency.LINE_BYTES // 4, fp // latency.LINE_BYTES
    assert chain.dtype == torch.int32 and chain.numel() == fp // 4
    seen = ops.pchase(chain, n_lines + 1).numpy()
    assert seen[-1] == 0
    assert sorted(seen[:-1]) == list(range(0, n_lines * words, words))
    want = np.asarray(jops.pchase(jnp.asarray(chain.numpy()), 200))
    np.testing.assert_array_equal(ops.pchase(chain, 200).numpy(), want)


def _gemm_tol(dtype, k):
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    return dict(rtol=tol, atol=tol * k)


def _gemm_inputs(m, k, n, dtype, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(m, k).astype(np.float32)
    y = rng.randn(k, n).astype(np.float32)
    return (torch.from_numpy(x).to(dtype), torch.from_numpy(y).to(dtype),
            jnp.asarray(x, JDTYPE[dtype]), jnp.asarray(y, JDTYPE[dtype]))


@pytest.mark.parametrize("m,k,n", [(128, 128, 128), (256, 512, 128),
                                   (384, 256, 640)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gemm_matches_reference_pallas_kernel(m, k, n, dtype):
    """The shapes and tolerances of ``test_kernels.py::test_gemm_sweep``,
    against the Pallas kernel run in interpret mode at 128^3 blocks."""
    x, y, jx, jy = _gemm_inputs(m, k, n, dtype)
    want = np.asarray(jgemm_raw(jx, jy, bm=128, bk=128, bn=128,
                                interpret=True), np.float32)
    for block in (None, *TILES[dtype]):
        got = ops.gemm(x, y, block=block)
        assert got.dtype == dtype and got.shape == (m, n)
        np.testing.assert_allclose(got.float().numpy(), want,
                                   **_gemm_tol(dtype, k))


@pytest.mark.parametrize("m,k,n", [(100, 300, 70), (1, 127, 33),
                                   (127, 1, 5), (37, 64, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gemm_ragged_matches_reference_ops(m, k, n, dtype):
    """Ragged shapes against the reference's ``ops.gemm``, which snaps its
    blocks to divisors of each dim; the port's kernel masks the edges."""
    x, y, jx, jy = _gemm_inputs(m, k, n, dtype, seed=1)
    want = np.asarray(jops.gemm(jx, jy), np.float32)
    got = ops.gemm(x, y)
    np.testing.assert_allclose(got.float().numpy(), want,
                               **_gemm_tol(dtype, k))


@pytest.mark.parametrize("table", ["volta", "pascal"])
def test_fixed_latency_method_matches_reference(table):
    """Every op of Table 4.1: the control-word method gives the
    reference's answer (and so the table's), at both stall ceilings."""
    ours = (hwmodel.VOLTA_INSTR_LATENCY if table == "volta"
            else hwmodel.PASCAL_INSTR_LATENCY)
    theirs = (jhwmodel.VOLTA_INSTR_LATENCY if table == "volta"
              else jhwmodel.PASCAL_INSTR_LATENCY)
    assert ours == theirs
    board, jboard = latency.Scoreboard(ours), jlatency.Scoreboard(theirs)
    for op, lat in ours.items():
        for max_stall in (32, 100):
            got = latency.measure_fixed_latency(board, op, max_stall)
            assert got == jlatency.measure_fixed_latency(jboard, op,
                                                         max_stall)
        assert latency.measure_fixed_latency(board, op, 100) == lat
        for n in (1, 7, 64):
            assert latency.dependent_chain_cycles(board, op, n) == \
                jlatency.dependent_chain_cycles(jboard, op, n)


def test_scoreboard_flags_a_stale_read_like_the_reference():
    prog = [latency.ModelInstr("FFMA", 1, (0,), stall=1),
            latency.ModelInstr("FFMA", 2, (1,), stall=0)]
    jprog = [jlatency.ModelInstr(**dataclasses.asdict(i)) for i in prog]
    board = latency.Scoreboard(hwmodel.VOLTA_INSTR_LATENCY)
    jboard = jlatency.Scoreboard(jhwmodel.VOLTA_INSTR_LATENCY)
    assert board.run(prog) == jboard.run(jprog) == (3, False)


def test_measure_op_chain_on_cpu_tensor():
    x0 = torch.zeros(8)
    for name, fn in latency.standard_op_suite().items():
        ns = latency.measure_op_chain(fn, x0, n=16, repeats=2)
        assert ns > 0, name
        assert fn(x0).shape == x0.shape


P_GRID = [(m, k, n) for m in (256, 1024, 4096) for k in (512, 2048)
          for n in (256, 2048, 8192)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", P_GRID)
def test_chooser_picks_an_instantiated_tile_that_fits_and_beats_naive(m, k,
                                                                     n,
                                                                     dtype):
    """The reference's property (``test_hlo_roofline.py::
    test_autotuner_respects_vmem_and_beats_naive``) on its grid, priced on
    the H100 for each input type: the tile is one the kernel has for that
    type, fits one block's shared memory with its stages, and is modelled
    no slower than the type's naive tile."""
    in_bytes = torch.tensor([], dtype=dtype).element_size()
    p = autotune.GemmProblem(m=m, k=k, n=n, in_bytes=in_bytes)
    cfg, terms = autotune.choose_gemm_block(p)
    assert dataclasses.astuple(cfg) in TILES[dtype]
    assert cfg.smem_bytes(in_bytes) <= hwmodel.H100.smem_per_block
    assert 0 < terms["tile_efficiency"] <= 1
    assert autotune.tuning_gain(p)["speedup"] >= 1.0


def test_traffic_formula_is_the_reference_one():
    """The C-stationary traffic term is the reference's, unchanged, for
    the same tile; only the compute term is priced for the H100."""
    for shape in ((512, 512, 512), (1024, 4096, 1024), (2048, 2560, 9728),
                  (100, 300, 70)):
        for t in TILES[torch.float32] + TILES[torch.bfloat16]:
            _, ours = autotune.gemm_cost(autotune.GemmProblem(*shape),
                                         autotune.GemmConfig(*t))
            _, theirs = jautotune.gemm_cost(jautotune.GemmProblem(*shape),
                                            jautotune.GemmConfig(*t))
            assert ours["traffic_bytes"] == theirs["traffic_bytes"]


def test_tile_efficiency_counts_padding_and_waves():
    """Padding in m, k and n, and waves of the CTAs each SM holds at once
    (from ptxas's registers, shared memory and thread slots), times the
    share of the dispatch slots the resident warps fill: the fp32 (64, 16,
    64) tile holds 6 CTAs of 2 warps an SM (12 of the 16 warps that hide
    FFMA's 4-cycle latency on 4 schedulers), (128, 16, 128) one CTA of 8;
    each bf16 tile one CTA (its shared memory), its wgmma asynchronous."""
    c = autotune.GemmConfig(64, 16, 64)
    eff = lambda m, k, n: autotune.tile_efficiency(   # noqa: E731
        autotune.GemmProblem(m, k, n, in_bytes=4), c)
    wave = 132 * 6
    assert eff(64 * wave, 16, 64) == pytest.approx(0.75)   # one full wave
    assert eff(64 * (wave + 1), 16, 64) == pytest.approx(
        (wave + 1) / (2 * wave) * 0.75)
    assert eff(32 * wave, 16, 64) == pytest.approx(0.5 * 0.75)  # half a wave
    assert eff(64 * wave, 8, 64) == pytest.approx(0.5 * 0.75)   # k padded
    for in_bytes, tile, resident, share in (
            (4, (64, 16, 64), 6, 0.75), (4, (128, 16, 128), 1, 0.5),
            (2, (128, 64, 128), 1, 1.0), (2, (128, 64, 256), 1, 1.0)):
        cfg = autotune.GemmConfig(*tile)
        assert autotune.resident_ctas(cfg, in_bytes) == resident, tile
        assert autotune.dispatch_share(cfg, in_bytes) == share, tile
    for dtype, in_bytes in ((torch.float32, 4), (torch.bfloat16, 2)):
        assert autotune.naive_block(in_bytes) == autotune.GemmConfig(
            *min(TILES[dtype]))


def test_bf16_compute_term_is_priced_at_the_tensor_core_rate():
    """A bf16 tile's compute term runs at the tensor cores' dense rate, an
    fp32 tile's at the CUDA cores' FFMA rate, each over the same tile
    efficiency; the bf16 stages' shared memory is stages x (bm + bn) x bk
    x 2 bytes."""
    gpu = hwmodel.H100
    for (m, k, n) in ((2048, 2560, 9728), (100, 300, 70)):
        flops = 2.0 * m * k * n
        for in_bytes, peak in ((2, gpu.peak_bf16_flops),
                               (4, gpu.peak_fp32_flops)):
            p = autotune.GemmProblem(m, k, n, in_bytes=in_bytes)
            for t in autotune.tiles(in_bytes):
                _, terms = autotune.gemm_cost(p, autotune.GemmConfig(*t))
                assert terms["compute_s"] == pytest.approx(
                    flops / (peak * terms["tile_efficiency"]))
    cfg = autotune.GemmConfig(128, 64, 256)
    assert cfg.smem_bytes(2) == 4 * (128 + 256) * 64 * 2 == 196_608
    assert autotune.GemmConfig(128, 64, 128).smem_bytes(2) == 131_072


def test_ops_gemm_resolves_none_through_the_chooser():
    x, y, _, _ = _gemm_inputs(2048, 256, 4096, torch.float32)
    cfg, _ = autotune.choose_gemm_block(autotune.GemmProblem(
        2048, 256, 4096, in_bytes=4))
    assert ops._check_gemm(x, y, None) == dataclasses.astuple(cfg)


def test_gemm_contract_raises():
    x, y = torch.randn(8, 4), torch.randn(4, 6)
    with pytest.raises(TypeError, match="float32/bfloat16"):
        ops.gemm(x.double(), y.double())
    with pytest.raises(TypeError, match="float32/bfloat16"):
        ops.gemm(x, y.bfloat16())
    with pytest.raises(ValueError, match="ranks"):
        ops.gemm(x[0], y)
    with pytest.raises(ValueError, match="inner dims"):
        ops.gemm(x, y.t())
    with pytest.raises(ValueError, match="tile"):
        ops.gemm(x, y, block=(128, 128, 128))


@pytest.mark.parametrize("dtype,other", [(torch.float32, torch.bfloat16),
                                         (torch.bfloat16, torch.float32)])
def test_gemm_refuses_a_tile_of_the_other_dtype(dtype, other):
    """Each dtype's kernel takes only its own tiles: the fp32 CUDA-core
    tiles are not the bf16 tensor-core ones, and ``_check_gemm`` raises
    on a tile of the other set before anything launches."""
    x, y = torch.randn(8, 4).to(dtype), torch.randn(4, 6).to(dtype)
    for tile in TILES[other]:
        with pytest.raises(ValueError, match=f"instantiates for {dtype}"):
            ops._check_gemm(x, y, tile)
    for tile in TILES[dtype]:
        assert ops._check_gemm(x, y, tile) == tile


def test_pchase_contract_raises():
    chain = torch.from_numpy(_perm_chain(16, 0))
    with pytest.raises(ValueError, match="int32"):
        ops.pchase(chain.long(), 4)
    with pytest.raises(ValueError, match="rank-1"):
        ops.pchase(chain.reshape(4, 4), 4)
    with pytest.raises(ValueError, match="contiguous"):
        ops.pchase(torch.zeros(32, dtype=torch.int32)[::2], 4)
    with pytest.raises(ValueError, match="step"):
        ops.pchase(chain, 0)
    for bad in (16, -1):
        c = chain.clone()
        c[3] = bad
        with pytest.raises(ValueError, match="outside"):
            ops.pchase(c, 4)
    ops.pchase(chain, 4)                       # checked once, then trusted
    chain[5] = 99                              # until it is written again
    with pytest.raises(ValueError, match="outside"):
        ops.pchase(chain, 4)


def test_autotune_gemm_launcher_rehearses_on_cpu(capsys):
    out = autotune_launch.main(["--device", "cpu"])
    assert [r["shape"] for r in out["problems"]] == [
        (512, 512, 512), (1024, 4096, 1024)]
    for r in out["problems"]:
        assert r["tuned"] in TILES[torch.bfloat16]
        assert r["modelled_speedup"] >= 1.0
    assert "== plain version (CPU): OK" in capsys.readouterr().out


def test_latency_launcher_rehearses_on_cpu(capsys):
    out = latency_launch.main(["--device", "cpu"])
    assert out["table_4_1"] == {"volta": (25, 25), "pascal": (43, 43)}
    assert set(out["op_chain_ns"]) == set(latency.standard_op_suite())
    assert all(v > 0 for v in out["chase_ns"].values())
    assert "not a device number" in capsys.readouterr().out


def test_probe_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is valid")
    for call in (lambda: autotune_launch.main([]),
                 lambda: latency_launch.main([]),
                 lambda: latency.line_chain(4096),
                 lambda: latency.chase_ns_per_step(4096)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
