"""A cell built from files alone: a smoke configuration, two traffic
files and a metric file added to a copy of the checkout are found by
name and driven through the port's engine on the CPU (the kernels' plain
versions) in a rehearsal that reports no device number. The measuring
path refuses to run without a card, and without the program."""

import json
import subprocess
import sys

import pytest

from portbench.tests.smoke import add_smoke_cells, make_checkout

METRIC = '''"""smoke_ticks: engine ticks over the window (a counter)."""


def read(run):
    return run.counters1["ticks"] - run.counters0["ticks"]
'''


def run_cell(root, *args):
    return subprocess.run(
        [sys.executable, "portbench/run.py", *args], cwd=root,
        capture_output=True, text=True, timeout=300)


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    root = make_checkout(tmp_path_factory.mktemp("discovery"))
    add_smoke_cells(root)
    (root / "portbench/metrics/smoke_ticks.py").write_text(METRIC)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({
        "name": "smoke_ticks", "unit": "ticks", "better": "higher",
        "source": "program_counter", "layer": "scheduler (serve/engine.py)",
        "moves": "itl_p95_ms",
        "workloads": ["granite-smoke.closed", "granite-smoke.open"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.mark.parametrize("loop", ["closed", "open"])
def test_a_cell_added_as_files_is_found_and_driven(checkout, loop):
    out = run_cell(checkout, "--workload", f"granite-smoke.{loop}",
                   "--seed", str(2**31 + 11), "--seconds", "3",
                   "--trace", "1", "--rehearse")
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    assert result["attempted"] > 0 and result["failed"] == 0
    assert result["metrics"]["smoke_ticks"]["value"] > 0
    assert result["device"]["platform"] == "cpu"
    assert "busy_s" not in result["device"]
    # No device number: no host-clock, span or trace metric in a rehearsal.
    assert set(result["metrics"]) == {"smoke_ticks"}
    assert list(result)[-1] == "checks"
    assert "check max_gap" in out.stderr.strip().splitlines()[-1]


def test_without_a_card_the_run_refuses_and_prints_no_result(checkout):
    out = run_cell(checkout, "--workload", "granite-smoke.closed",
                   "--seed", "5", "--seconds", "1", "--trace", "0")
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_without_the_program_the_run_fails(tmp_path):
    root = make_checkout(tmp_path, with_src=False)
    add_smoke_cells(root)
    out = run_cell(root, "--workload", "granite-smoke.open",
                   "--seed", "5", "--seconds", "1", "--trace", "0",
                   "--rehearse")
    assert out.returncode != 0
    assert out.stdout.strip() == ""
