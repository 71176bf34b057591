"""The benchmark's traffic: the copied generator draws as the port's does,
one seed gives the same arrivals, and seeds change the order and the
tokens but not the set of sizes and arrivals."""

import json
from collections import Counter

import numpy as np
import pytest

from portbench import traffic
from portbench.tests.smoke import ROOT


def spec(name):
    return json.loads((ROOT / "portbench" / "traffic" / f"{name}.json")
                      .read_text())


def shapes(arrs):
    return [(len(a.prompt), a.max_new) for a in arrs]


@pytest.mark.parametrize("process", ["poisson", "bursty"])
def test_copy_draws_as_the_ports_generator(process):
    """Draw for draw the port's stream, times in seconds where the port
    counts ticks (its tick is the floor of the same time)."""
    from repro_torch.serve import traffic as port
    classes = (dict(name="a", weight=2.0, prompt_lo=5, prompt_hi=90,
                    out_lo=3, out_hi=40),
               dict(name="b", prompt_lo=4, prompt_hi=9, out_lo=2, out_hi=5,
                    sessions=3, prefix_len=6))
    ours = traffic.TrafficGenerator(traffic.TrafficConfig(
        rate=0.7, n_requests=60, seed=2**33 + 5, process=process,
        classes=tuple(traffic.TrafficClass(**c) for c in classes),
        vocab=300)).arrivals()
    theirs = port.TrafficGenerator(port.TrafficConfig(
        rate=0.7, n_requests=60, seed=2**33 + 5, process=process,
        classes=tuple(port.TrafficClass(**c) for c in classes),
        vocab=300)).arrivals()
    for a, b in zip(ours, theirs):
        assert int(a.arrival_s) == b.tick
        assert (a.rclass, a.max_new, a.session_id) == \
            (b.rclass, b.max_new, b.session_id)
        np.testing.assert_array_equal(a.prompt, b.prompt)


@pytest.mark.parametrize("cell", ["granite-3-8b.chat-closed192",
                                  "granite-3-8b.rag-open"])
def test_one_seed_gives_the_same_arrivals(cell):
    s = spec(cell)
    a = traffic.Mix(s, 2**31 + 77, 49155).take(150)
    b = traffic.Mix(s, 2**31 + 77, 49155).take(150)
    for x, y in zip(a, b):
        assert (x.arrival_s, x.rid, x.max_new) == \
            (y.arrival_s, y.rid, y.max_new)
        np.testing.assert_array_equal(x.prompt, y.prompt)


def test_seeds_share_each_rounds_sizes_and_arrivals():
    """A shuffled mix (the closed chat cell): every round holds the same
    sizes and spans the same offered time whatever the seed; the order
    and the tokens differ."""
    s = dict(spec("granite-3-8b.chat-closed192"), loop="open", rate=2.0)
    r = s["round"]
    a, b = (traffic.Mix(s, seed, 49155).take(3 * r) for seed in (1, 2))
    for k in range(3):
        ra, rb = a[k * r:(k + 1) * r], b[k * r:(k + 1) * r]
        assert Counter(shapes(ra)) == Counter(shapes(rb))
        assert ra[-1].arrival_s == pytest.approx(rb[-1].arrival_s)
    assert shapes(a) != shapes(b)
    assert not np.array_equal(a[0].prompt[:8], b[0].prompt[:8]) or \
        len(a[0].prompt) != len(b[0].prompt)


def test_a_fixed_trace_changes_only_the_tokens():
    """``shuffle_block`` 1 (the open rag cell): one trace for every seed;
    the seed draws the prompts' tokens."""
    s = spec("granite-3-8b.rag-open")
    a, b = (traffic.Mix(s, seed, 49155).take(200) for seed in (1, 2))
    assert [(x.arrival_s, len(x.prompt), x.max_new) for x in a] == \
        [(x.arrival_s, len(x.prompt), x.max_new) for x in b]
    assert any(not np.array_equal(x.prompt, y.prompt) for x, y in zip(a, b))
    lo, hi = s["prompt"]
    assert all(lo <= len(x.prompt) <= hi for x in a)


def test_rate_scales_the_offered_time():
    s = spec("granite-3-8b.rag-open")
    slow = traffic.Mix(s, 3, 49155, rate=2.0)
    fast = traffic.Mix(s, 3, 49155, rate=4.0)
    assert slow.gaps.sum() == pytest.approx(2 * fast.gaps.sum())
    assert shapes(slow.take(50)) == shapes(fast.take(50))
