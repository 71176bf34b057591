"""The port's device-model dissection against the reference's: V100 and
P100 (P4, M60 and K80 in ``test_torch_dissect_more.py``, so that
pytest-xdist's ``--dist loadfile`` gives the two files to two workers).

``dissect.dissect(spec)`` of each package, field for field: the recovered
L1, L2, latency classes, TLBs, register banks, shared-memory curve and the
``compare_to_spec`` verdicts; and Fig 3.2's cold-scan latencies. Each
card's two dissections run once for the file.
"""

import dataclasses
import functools

import numpy as np
import pytest

from repro.core import dissect as rdissect
from repro.core import hwmodel as rhw
from repro.core import simulator as rsim
from repro_torch.core import dissect, hwmodel, simulator

CARDS = ("V100", "P100")
FIELDS = ("gpu", "l1", "l2", "latency", "tlbs", "reg_banks",
          "reg_bank_width", "smem_latency_curve", "matches")


@functools.lru_cache(maxsize=None)
def dissections(name):
    """(port, reference) ``DissectionReport`` of ``name``."""
    return (dissect.dissect(hwmodel.GPUS[name]),
            rdissect.dissect(rhw.GPUS[name]))


def reports(name):
    """(port, reference) dissections of ``name`` as dicts."""
    return tuple(dataclasses.asdict(r) for r in dissections(name))


@pytest.mark.parametrize("field", FIELDS)
@pytest.mark.parametrize("name", CARDS)
def test_dissection_field_equals_the_reference(name, field):
    port, ref = reports(name)
    assert port[field] == ref[field]


@pytest.mark.parametrize("name", CARDS)
def test_every_published_entry_recovered(name):
    """As ``tests/test_pchase.py`` asserts for these cards."""
    port, _ = reports(name)
    assert port["matches"] and all(port["matches"].values()), \
        port["matches"]


def test_v100_matches_equal_compare_to_spec():
    rep, _ = dissections("V100")
    assert dissect.compare_to_spec(rep, hwmodel.V100) == rep.matches
    assert set(rep.matches) == {
        "l1_size", "l1_line", "l1_sets", "l1_hit_latency", "l1_policy",
        "l2_size", "l2_line", "l2_hit_latency", "l2_ways",
        "latency_classes", "l1_tlb", "l2_tlb", "reg_banks",
        "reg_bank_width"}


@pytest.mark.parametrize("name", CARDS)
def test_fig_3_2_cold_scan_equals_the_reference(name):
    port = simulator.build_hierarchy(hwmodel.GPUS[name])
    ref = rsim.build_hierarchy(rhw.GPUS[name])
    addrs = np.arange(0, 512, 8)
    got, want = port.scan(addrs), ref.scan(addrs)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int64
    if name == "V100":
        assert sorted(set(got.tolist())) == [28, 193, 375, 1029]
