"""On the card, at each cell's own size (its traffic file as it stands:
batch, clients, pool and a window of ``run_seconds``): the program's
widest gap is within the cell's limit, and the control (the fp32
reference with every product's inputs in fp8, put in the program's place
on the same prompts and served tokens) comes out not correct through the
same ``judge.verdict``; and the chat cell with half of its decode batch
given the other half's picks comes out not correct.

    PYTHONPATH=src python -m pytest portbench/tests -m card -s
"""

import gc
import json
import os
import sys

import pytest

from portbench import judge
from portbench import run as run_mod
from portbench.tests.smoke import make_checkout

CHAT, RAG = "granite-3-8b.chat-closed192", "granite-3-8b.rag-open"


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    return make_checkout(tmp_path_factory.mktemp("card"))


def run_cell(root, monkeypatch, cell, seed, seconds=None):
    """One whole run of ``cell`` in ``root``; returns its result line and
    what its check read."""
    for var in ("TORCH_EXTENSIONS_DIR", "TRITON_CACHE_DIR", "CUDA_CACHE_PATH",
                "REPRO_TORCH_TUNING_CACHE"):
        monkeypatch.setenv(var, os.environ.get(var, ""))
    monkeypatch.setattr(sys, "path", list(sys.path))
    if seconds is None:
        seconds = json.loads((root / "BENCHMARK.json").read_text())[
            "run_seconds"]
    code, result, kept = run_mod.execute(run_mod.parse(
        ["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
         "--trace", "0"]), keep=True, root=root)
    assert code == 0
    return result, kept


def release():
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


@pytest.mark.card
@pytest.mark.parametrize("seed", [2**31 + 101, 2**31 + 102, 2**31 + 103])
@pytest.mark.parametrize("cell", [CHAT, RAG])
def test_the_control_fails_the_limit_the_program_meets(cuda_device, checkout,
                                                       monkeypatch, cell,
                                                       seed):
    result, kept = run_cell(checkout, monkeypatch, cell, seed)
    try:
        program = result["checks"]["max_gap"]
        gaps = judge.control_gaps(kept["params"], kept["cell"].config,
                                  kept["sampled"], cuda_device)
        control = judge.verdict(gaps, program["limit"])
        print(json.dumps({"cell": cell, "seed": seed,
                          "program": program["value"],
                          "control": control["max_gap"],
                          "limit": program["limit"],
                          "tokens": control["tokens"],
                          "metrics": {k: v["value"] for k, v
                                      in result["metrics"].items()}}))
        assert result["correct"], result["checks"]
        assert control["tokens"] >= kept["cell"].spec["judge"]["min_tokens"]
        assert control["correct"] is False
    finally:
        kept = None
        release()


@pytest.mark.card
def test_half_of_the_batch_left_out_at_the_cells_size(cuda_device, checkout,
                                                      monkeypatch):
    """The chat cell's decode step with its second half of the slots
    given the first half's picks."""
    from repro_torch.serve.engine import ServingEngine
    step = ServingEngine._decode_step

    def half(self, active):
        nxt = step(self, active)
        h = len(nxt) // 2
        nxt[h:] = nxt[:len(nxt) - h]
        return nxt

    monkeypatch.setattr(ServingEngine, "_decode_step", half)
    result, kept = run_cell(checkout, monkeypatch, CHAT, 2**31 + 104, 20)
    kept = None
    release()
    print(json.dumps({"cell": CHAT, "fault": "half of the batch",
                      "checks": result["checks"]}))
    assert result["correct"] is False
