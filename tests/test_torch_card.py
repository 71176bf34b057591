"""The card's dissection, what of it runs on the CPU.

``core.card`` drives the ch.3 detectors on the H100 through the timed
chase; the card itself is only on the GPU machine (``chip_smoke.py`` phase
20, ``tests/test_torch_cuda.py``). Here: the class-snapping rule on
synthetic cycle counts; the replay bookkeeping of ``ReplayHierarchy``
(every scan since ``flush()`` replayed from a cold device, one chain built
from the address list, a repeated address refused), held to the
simulator's own scans through ``simulator.MemoryHierarchy.chase``;
``pchase_timed``'s plain version against the simulator's chase over
``make_chain`` chains; and ``launch/dissect.py --model V100 --device cpu``.
"""

import json

import numpy as np
import pytest
import torch

from repro.core import regbank as rregbank
from repro.core import regremap as rregremap
from repro.core import hwmodel as rhw
from repro_torch.core import card, hwmodel, pchase, simulator
from repro_torch.kernels import ops, ref
from repro_torch.launch import dissect as dissect_launch

KiB = 1024


# ----------------------------------------------------------------------------
# The snapping rule
# ----------------------------------------------------------------------------

def _jittered(rng, centre, spread, n):
    return rng.randint(centre - spread, centre + spread + 1, n)


def test_snapper_puts_each_jittering_class_on_one_value():
    rng = np.random.RandomState(0)
    raw = np.concatenate([np.full(200, 72), _jittered(rng, 320, 30, 300),
                          _jittered(rng, 760, 40, 100)])
    rng.shuffle(raw)
    s = card.ClassSnapper()
    got = s.snap(raw)
    assert len(set(got.tolist())) == 3
    assert got[raw == 72].tolist() == [72] * 200
    assert len(set(got[(raw > 200) & (raw < 500)].tolist())) == 1
    assert sorted(s.classes) == sorted(set(got.tolist()))


def test_snapper_keeps_a_class_across_scans():
    rng = np.random.RandomState(1)
    s = card.ClassSnapper()
    first = s.snap(_jittered(rng, 310, 20, 500))
    (c,) = set(first.tolist())
    # A later scan whose counts sit higher in the same class, within the
    # tolerance of the first one's median, reads the same class.
    later = s.snap(_jittered(rng, 335, 15, 500))
    assert set(later.tolist()) == {c}
    assert s.classes == [c]


def test_snapper_makes_a_class_beyond_the_tolerance():
    s = card.ClassSnapper()
    s.snap(np.full(10, 300))
    step = int(300 * card.SNAP_REL) + 2
    got = s.snap(np.full(10, 300 + step))
    assert got.tolist() == [300 + step] * 10
    assert s.classes == [300, 300 + step]
    assert s.snap(np.full(3, 300 + step - 1)).tolist() == [300 + step] * 3


def test_snapper_splits_at_gaps_and_caps_a_clusters_width():
    s = card.ClassSnapper()
    assert s.clusters(np.array([72, 73, 71, 300, 310])) == [
        (71, 73, 72), (300, 310, 300)]
    # A dense run from 500 to 1500 chains under the gap rule alone; the
    # width cap cuts it into clusters no wider than SNAP_WIDTH.
    parts = s.clusters(np.arange(500, 1501))
    assert len(parts) > 1
    assert all(hi <= card.SNAP_WIDTH * lo for lo, hi, _ in parts)
    assert parts[0][0] == 500 and parts[-1][1] == 1500
    assert s.clusters(np.array([], dtype=np.int64)) == []
    # The absolute tolerance holds at small counts: 8 cycles apart joins.
    assert len(s.clusters(np.array([40, 48]))) == 1
    assert len(s.clusters(np.array([40, 49]))) == 2


def test_snapper_leaves_a_single_outlier_its_own_class():
    s = card.ClassSnapper()
    raw = np.concatenate([np.full(999, 72), [5000]])
    got = s.snap(raw)
    assert (got[:-1] == 72).all() and got[-1] == 5000


# ----------------------------------------------------------------------------
# The replay bookkeeping, against the simulator
# ----------------------------------------------------------------------------

class SimReplay(card.ReplayHierarchy):
    """``ReplayHierarchy`` over the device model: the chain laid out as the
    card lays it out, walked by ``MemoryHierarchy.chase`` from a flushed
    model, the replayed steps untimed. The model's latencies are exact, so
    nothing is snapped."""

    def __init__(self, hier):
        super().__init__()
        self.hier = hier
        self.walks = []

    def load(self, addrs):
        self.chain = card.chain_of(addrs, int(addrs.max()) // 8 + 1)

    def walk(self, start, warm, steps):
        self.walks.append((start, warm, steps))
        return self.hier.chase(self.chain, start=start, steps=warm + steps,
                               flush=True)[warm:]


def _pair():
    return (SimReplay(simulator.build_hierarchy(hwmodel.V100)),
            simulator.build_hierarchy(hwmodel.V100))


def test_replay_gives_the_simulators_scans():
    replay, plain = _pair()
    addrs = np.arange(0, 96 * KiB, 32, dtype=np.int64)
    for h in (replay, plain):
        h.flush()
    for _ in range(3):
        np.testing.assert_array_equal(replay.scan(addrs), plain.scan(addrs))
    n = addrs.size
    assert replay.walks == [(0, 0, n), (0, n, n), (0, 2 * n, n)]
    replay.flush()
    plain.flush()
    np.testing.assert_array_equal(replay.scan(addrs[::-1]),
                                  plain.scan(addrs[::-1]))
    assert replay.walks[-1] == (int(addrs[-1]), 0, n)


@pytest.mark.parametrize("detector", ["size", "line", "classes", "ways",
                                      "hit"])
def test_detectors_on_the_replay_match_the_simulator(detector):
    replay, plain = _pair()
    run = {
        "size": lambda h: pchase.detect_size(h, lo=2 * KiB, hi=256 * KiB,
                                             stride=8),
        "line": lambda h: pchase.detect_line(h, 64 * KiB),
        "classes": lambda h: pchase.latency_classes(h, span=16 * KiB),
        "ways": lambda h: pchase.detect_ways(h, 16 * KiB, 193,
                                             max_ways=64),
        "hit": lambda h: pchase.measure_next_level_latency(h, 32 * KiB),
    }[detector]
    assert run(replay) == run(plain)


def test_tlb_sweep_on_the_replay_matches_the_simulator():
    def hier():
        return simulator.build_hierarchy(hwmodel.V100, l1_enabled=False,
                                         caches_enabled=False)
    replay = SimReplay(hier())
    args = ([64 * KiB, 512 * KiB, 2 * 2**20], [2 * 2**20, 32 * 2**20], 300)
    assert pchase.dissect_tlbs(replay, *args) == \
        pchase.dissect_tlbs(hier(), *args)


def test_scan_refuses_what_one_chain_cannot_replay():
    replay, _ = _pair()
    with pytest.raises(ValueError, match="distinct"):
        replay.scan(np.array([0, 64, 0]))
    with pytest.raises(ValueError, match="multiples of 8"):
        replay.scan(np.array([0, 12]))
    with pytest.raises(ValueError, match="multiples of 8"):
        replay.scan(np.array([-8, 0]))
    with pytest.raises(ValueError, match="no address"):
        replay.scan(np.array([], dtype=np.int64))
    replay.flush()
    replay.scan(np.array([0, 64]))
    with pytest.raises(ValueError, match="repeat one address list"):
        replay.scan(np.array([0, 128]))
    replay.flush()
    replay.scan(np.array([0, 128]))


def test_chain_of_is_the_make_chain_format():
    for n_bytes, stride, start in ((4096, 64, 0), (64 * KiB, 8, 512)):
        want = simulator.make_chain(n_bytes, stride, start)
        addrs = start + np.arange(n_bytes // stride) * stride
        np.testing.assert_array_equal(card.chain_of(addrs, want.size), want)


# ----------------------------------------------------------------------------
# The timed chase's plain version
# ----------------------------------------------------------------------------

class Recording(simulator.MemoryHierarchy):
    """The device model, keeping the address of every load."""

    def access(self, addr):
        self.seen.append(addr)
        return super().access(addr)


@pytest.mark.parametrize("n_bytes,stride,start,warm",
                         [(4096, 64, 0, 0), (64 * KiB, 8, 512, 100),
                          (2**20, 128, 0, 9000), (300, 96, 8, 2)])
def test_plain_timed_chase_follows_the_simulators_chase(n_bytes, stride,
                                                        start, warm):
    chain = simulator.make_chain(n_bytes, stride, start)
    spec = hwmodel.V100
    base = simulator.build_hierarchy(spec)
    sim = Recording(base.l1, base.l2, base.l1_tlb, base.l2_tlb, base.lat)
    sim.seen = []
    steps = 3 * len(chain) // max(1, stride // 8) + 5
    sim.chase(chain, start=start, steps=warm + steps, flush=True)
    got, cycles, total = ops.pchase_timed(torch.from_numpy(chain), steps,
                                          start=start, warm=warm)
    assert cycles is None and total is None
    assert got.dtype == torch.int64
    assert got.tolist() == sim.seen[warm:]
    np.testing.assert_array_equal(
        got.numpy(), ref.pchase_timed(torch.from_numpy(chain), steps,
                                      start, warm).numpy())


def test_timed_chase_wrapper_refuses_what_the_kernel_does_not_take():
    chain = torch.from_numpy(simulator.make_chain(4096, 64))
    assert ops.pchase_timed(chain, 4, offsets=False) == (None, None, None)
    for kw, match in ((dict(steps=0), "steps"), (dict(warm=-1), "warm"),
                      (dict(start=12), "slot"), (dict(start=1 << 20),
                                                 "slot"),
                      (dict(carveout=101), "carveout"),
                      (dict(carveout=-1), "carveout")):
        args = dict(steps=4)
        args.update(kw)
        with pytest.raises(ValueError, match=match):
            ops.pchase_timed(chain, **args)
    with pytest.raises(ValueError, match="int64"):
        ops.pchase_timed(chain.int(), 4)
    with pytest.raises(ValueError, match="int64"):
        ops.pchase_timed(chain[::2], 4)
    with pytest.raises(ValueError, match="outside the chain"):
        ops.pchase_timed(torch.full((4,), 3, dtype=torch.int64), 2)
    with pytest.raises(ValueError, match="outside the chain"):
        ops.pchase_timed(torch.full((4,), 64, dtype=torch.int64), 2)
    ops.reset_launches()
    ops.pchase_timed(chain, 4)
    assert not any(ops.LAUNCHES.values())    # the plain version counts none


# ----------------------------------------------------------------------------
# The card's own parts, and the launcher
# ----------------------------------------------------------------------------

def test_card_parts_raise_on_the_cpu():
    with pytest.raises(RuntimeError, match="CUDA card"):
        card.CardHierarchy(device="cpu")
    with pytest.raises(RuntimeError, match="CUDA card"):
        card.dissect_card(device="cpu")
    with pytest.raises(RuntimeError, match="CUDA card"):
        dissect_launch.main(["--device", "cpu"])


def test_smem_configs_and_nominal_l1():
    assert card.smem_config(0) == 0
    assert card.smem_config(50) == 132 * KiB
    assert card.smem_config(100) == 228 * KiB
    assert card.L1_PLUS_SMEM - card.smem_config(100) == 28 * KiB
    rep = card.CardReport(gpu="x", l1=None, l2=None, latency=None, tlbs=[],
                          reg_banks=None, reg_bank_width=None,
                          smem_latency_curve={}, sm_clock_mhz=1500.0)
    assert rep.ns(300) == 200.0


def test_dissect_launcher_on_the_v100_model(capsys):
    out = dissect_launch.main(["--model", "V100", "--device", "cpu"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    v100 = printed["models"]["V100"]
    assert all(v100["matches"].values()) and len(v100["matches"]) == 14
    assert v100["l1"]["size"] == 121 * KiB and v100["tlbs"][1] == {
        "page_entry": 32 * 2**20, "coverage": 8192 * 2**20}
    assert {k: v // KiB for k, v in out["table_3_3"].items()} == {
        0: 121, 64: 57, 96: 25}
    rf = rhw.V100.regfile
    want = (rregbank.gflops_per_sm(rf, rregbank.parse_listing(
        rregbank.NVCC_LISTING), 1380.0),
        rregbank.gflops_per_sm(rf, rregremap.remap_tile(
            rf, rregbank.A_REGS, rregbank.B_REGS, list(range(16, 80))),
            1380.0))
    assert (printed["ch1"]["nvcc_gflops_per_sm"],
            printed["ch1"]["remapped_gflops_per_sm"]) == want
    assert printed["ch1"]["conflict_free"]
