"""The port's copies of the paper's numpy models against the reference's.

The paper's cards (``hwmodel``), the register-bank model and the Ch.1
listings (``regbank``), the conflict-free remapping (``regremap``), the
tensor-core fragment maps (``tensorcore``), the control-word codec
(``isa``), the warp-scheduler model (``scheduler``) and the atomics fits
(``atomics``): the same call on the same inputs gives the same answer.
Exact where the arithmetic is the same; the fits within 1e-9 and the MMA
emulation within 1e-6 (both run the same numpy operations; the bounds
leave room for a BLAS that sums in another order).
"""

import dataclasses

import numpy as np
import pytest

from repro.configs import v100_microbench as ref_config
from repro.core import atomics as ratomics
from repro.core import hwmodel as rhw
from repro.core import isa as risa
from repro.core import regbank as rregbank
from repro.core import regremap as rregremap
from repro.core import scheduler as rscheduler
from repro.core import tensorcore as rtensorcore
from repro_torch.configs import v100_microbench
from repro_torch.core import (atomics, hwmodel, isa, regbank, regremap,
                              scheduler, tensorcore)

CARDS = ("V100", "P100", "P4", "M60", "K80")


@pytest.mark.parametrize("name", CARDS)
def test_paper_card_records_equal_the_reference(name):
    assert dataclasses.asdict(hwmodel.GPUS[name]) == \
        dataclasses.asdict(rhw.GPUS[name])
    assert getattr(hwmodel, name) is hwmodel.GPUS[name]


def test_card_tables_and_names():
    assert list(hwmodel.GPUS) == list(rhw.GPUS)
    for table in ("VOLTA_ATOMIC_LATENCY", "PASCAL_P100_ATOMIC_LATENCY",
                  "MAXWELL_ATOMIC_LATENCY", "KEPLER_ATOMIC_LATENCY",
                  "VOLTA_INSTR_LATENCY", "PASCAL_INSTR_LATENCY"):
        assert getattr(hwmodel, table) == getattr(rhw, table)
    assert (hwmodel.KiB, hwmodel.MiB) == (rhw.KiB, rhw.MiB)
    # The H100's limits record keeps its own name; the paper's is apart.
    assert hwmodel.H100.name == "H100 SXM"
    assert not isinstance(hwmodel.V100, hwmodel.GPUSpec)


def test_v100_microbench_config_equals_the_reference():
    assert dataclasses.asdict(v100_microbench.GPU) == \
        dataclasses.asdict(ref_config.GPU)
    assert v100_microbench.PROBES == ref_config.PROBES


# ----------------------------------------------------------------------------
# regbank
# ----------------------------------------------------------------------------

LISTINGS = ("NVCC_LISTING", "IMPROVED_LISTING")


@pytest.mark.parametrize("listing", LISTINGS)
def test_parse_listing_equals_the_reference(listing):
    got = regbank.parse_listing(getattr(regbank, listing))
    want = rregbank.parse_listing(getattr(rregbank, listing))
    assert [dataclasses.astuple(i) for i in got] == \
        [dataclasses.astuple(i) for i in want]
    assert [str(i) for i in got] == [str(i) for i in want]
    assert regbank.tile_coverage(got) == rregbank.tile_coverage(want)


@pytest.mark.parametrize("listing", LISTINGS)
@pytest.mark.parametrize("name", ["V100", "P100"])
@pytest.mark.parametrize("mode", ["pair", "next"])
def test_instruction_cycles_equal_the_reference(listing, name, mode):
    got = regbank.instruction_cycles(
        hwmodel.GPUS[name].regfile,
        regbank.parse_listing(getattr(regbank, listing)), reuse_mode=mode)
    want = rregbank.instruction_cycles(
        rhw.GPUS[name].regfile,
        rregbank.parse_listing(getattr(rregbank, listing)), reuse_mode=mode)
    assert got == want


@pytest.mark.parametrize("listing", LISTINGS)
def test_gflops_per_sm_at_1380_mhz_equals_the_reference(listing):
    got = regbank.gflops_per_sm(
        hwmodel.V100.regfile,
        regbank.parse_listing(getattr(regbank, listing)), 1380.0)
    want = rregbank.gflops_per_sm(
        rhw.V100.regfile,
        rregbank.parse_listing(getattr(rregbank, listing)), 1380.0)
    assert got == want
    assert (regbank.PAPER_GFLOPS_NVCC, regbank.PAPER_GFLOPS_IMPROVED) == \
        (rregbank.PAPER_GFLOPS_NVCC, rregbank.PAPER_GFLOPS_IMPROVED)


@pytest.mark.parametrize("name", CARDS)
def test_register_bank_dissection_equals_the_reference(name):
    rf, rrf = hwmodel.GPUS[name].regfile, rhw.GPUS[name].regfile
    got = regbank.dissect_register_banks(
        lambda p: regbank.ffma_probe(rf, p),
        lambda t: regbank.ffma_probe(rf, t))
    want = rregbank.dissect_register_banks(
        lambda p: rregbank.ffma_probe(rrf, p),
        lambda t: rregbank.ffma_probe(rrf, t))
    assert got == want == (rf.banks, rf.bank_width_bits)
    sweep = regbank.conflict_sweep(lambda t: regbank.ffma_probe(rf, t),
                                   (96, 97), range(0, 32))
    assert sweep == rregbank.conflict_sweep(
        lambda t: rregbank.ffma_probe(rrf, t), (96, 97), range(0, 32))
    assert regbank._pattern_period(sweep) == \
        rregbank._pattern_period(sweep)


# ----------------------------------------------------------------------------
# regremap
# ----------------------------------------------------------------------------

def _tile_problems():
    """The reference's ``tile_problem`` cases drawn from a seeded
    generator: disjoint A, B and C ranges at random offsets."""
    rng = np.random.RandomState(11)
    out = []
    for _ in range(12):
        a0 = int(rng.randint(2, 21))
        b0 = a0 + 8 + int(rng.randint(0, 9))
        c0 = b0 + 8 + int(rng.randint(0, 9))
        rows, cols = int(rng.choice([4, 8])), int(rng.choice([4, 8]))
        out.append((tuple(range(a0, a0 + rows)), tuple(range(b0, b0 + cols)),
                    tuple(range(c0, c0 + 2 * rows * cols))))
    out.append((regbank.A_REGS, regbank.B_REGS, tuple(range(16, 80))))
    return out


@pytest.mark.parametrize("problem", _tile_problems(),
                         ids=lambda p: f"a{p[0][0]}x{len(p[0])}-"
                                       f"b{p[1][0]}x{len(p[1])}")
def test_remap_tile_equals_the_reference_and_is_conflict_free(problem):
    a, b, c_pool = problem
    rf = hwmodel.V100.regfile
    got = regremap.remap_tile(rf, a, b, c_pool)
    want = rregremap.remap_tile(rhw.V100.regfile, a, b, c_pool)
    assert [str(i) for i in got] == [str(i) for i in want]
    assert regremap.assign_accumulators(rf, a, b, c_pool) == \
        rregremap.assign_accumulators(rhw.V100.regfile, a, b, c_pool)
    assert regremap.conflict_free(rf, got)
    assert len({i.dst for i in got}) == len(a) * len(b)


def test_ch1_remapping_gives_the_references_gflops():
    rf = hwmodel.V100.regfile
    ours = regremap.remap_tile(rf, regbank.A_REGS, regbank.B_REGS,
                               list(range(16, 80)))
    theirs = rregremap.remap_tile(rhw.V100.regfile, rregbank.A_REGS,
                                  rregbank.B_REGS, list(range(16, 80)))
    assert regbank.gflops_per_sm(rf, ours, 1380.0) == \
        rregbank.gflops_per_sm(rhw.V100.regfile, theirs, 1380.0)
    assert regbank.tile_coverage(ours)


# ----------------------------------------------------------------------------
# tensorcore
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("matrix", ["A", "B", "C"])
def test_fragment_tables_equal_the_reference(matrix):
    np.testing.assert_array_equal(tensorcore.fragment_table(matrix),
                                  rtensorcore.fragment_table(matrix))
    np.testing.assert_array_equal(tensorcore.loads_per_thread(matrix),
                                  rtensorcore.loads_per_thread(matrix))


def test_group_blocks_and_steps_equal_the_reference():
    for g in range(tensorcore.GROUPS):
        assert tensorcore.group_block(g) == rtensorcore.group_block(g)
    for st in range(tensorcore.STEPS):
        assert tensorcore.step_subtile(st) == rtensorcore.step_subtile(st)
    for r in range(16):
        for c in range(16):
            assert tensorcore.c_group(r, c) == rtensorcore.c_group(r, c)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_emulate_mma_sync_equals_the_reference(seed):
    rng = np.random.RandomState(seed)
    a = rng.randn(16, 16).astype(np.float16)
    b = rng.randn(16, 16).astype(np.float16)
    c = rng.randn(16, 16).astype(np.float32)
    got = tensorcore.emulate_mma_sync(a, b, c)
    np.testing.assert_allclose(got, rtensorcore.emulate_mma_sync(a, b, c),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(
        got, a.astype(np.float32) @ b.astype(np.float32) + c, atol=1e-4)


# ----------------------------------------------------------------------------
# isa
# ----------------------------------------------------------------------------

def _controls():
    rng = np.random.RandomState(5)
    fields = dict(isa._FIELDS)
    return [isa.ControlInfo(**{k: int(rng.randint(0, 1 << w))
                               for k, w in fields.items()})
            for _ in range(16)] + [isa.ControlInfo()]


def test_control_codec_round_trips_and_equals_the_reference():
    for ctrl in _controls():
        word = ctrl.encode()
        assert word == risa.ControlInfo(**dataclasses.asdict(ctrl)).encode()
        assert isa.decode_control(word) == ctrl
        assert dataclasses.asdict(risa.decode_control(word)) == \
            dataclasses.asdict(ctrl)
        instr = (word * 2654435761) % (1 << 90)
        packed = isa.pack_volta(instr, ctrl)
        assert packed == risa.pack_volta(
            instr, risa.ControlInfo(**dataclasses.asdict(ctrl)))
        assert isa.unpack_volta(packed) == (instr, ctrl)


def test_pascal_word_and_tables_equal_the_reference():
    ctrls = _controls()[:3]
    word = isa.pack_pascal_control_word(ctrls)
    assert word == risa.pack_pascal_control_word(
        [risa.ControlInfo(**dataclasses.asdict(c)) for c in ctrls])
    assert word < 1 << 63
    assert isa.unpack_pascal_control_word(word) == ctrls
    assert isa.VOLTA_OPCODES == risa.VOLTA_OPCODES
    assert isa.opcode_length_histogram() == risa.opcode_length_histogram()
    assert isa.ENCODING_FACTS == risa.ENCODING_FACTS
    assert isa.SECTION_BITS == risa.SECTION_BITS


# ----------------------------------------------------------------------------
# scheduler and atomics
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("clock_mhz", [1380.0, 1530.0])
def test_table_2_1_equals_the_reference(clock_mhz):
    assert scheduler.table_2_1(clock_mhz) == rscheduler.table_2_1(clock_mhz)
    assert scheduler.PAPER_TABLE_2_1 == rscheduler.PAPER_TABLE_2_1
    assert scheduler.min_threads_to_saturate() == \
        rscheduler.min_threads_to_saturate() == 128
    assert [scheduler.scheduler_id(w) for w in range(16)] == \
        [rscheduler.scheduler_id(w) for w in range(16)]


ATOMIC_CARDS = [n for n in CARDS if hwmodel.GPUS[n].atomic_latency]


@pytest.mark.parametrize("name", ATOMIC_CARDS)
@pytest.mark.parametrize("space", ["shared", "global"])
def test_atomic_fits_and_residuals_equal_the_reference(name, space):
    spec, rspec = hwmodel.GPUS[name], rhw.GPUS[name]
    which = 0 if space == "shared" else 1
    np.testing.assert_allclose(
        atomics.fit_serialization(spec.atomic_latency, which),
        ratomics.fit_serialization(rspec.atomic_latency, which),
        atol=1e-9, rtol=0)
    got = atomics.model_residuals(spec, space)
    want = ratomics.model_residuals(rspec, space)
    assert list(got) == list(want)
    np.testing.assert_allclose([got[k] for k in got],
                               [want[k] for k in want], atol=1e-9, rtol=0)
    for scenario in (1, 2, 3, 4):
        assert abs(atomics.throughput_scenario(spec, scenario)
                   - ratomics.throughput_scenario(rspec, scenario)) <= 1e-9


def test_atomics_refuse_a_card_without_data():
    with pytest.raises(ValueError, match="no atomic data"):
        atomics.modeled_latency(hwmodel.P4, 4)
    with pytest.raises(ValueError):
        atomics.throughput_scenario(hwmodel.V100, 5)
