"""The check catches a broken timed path: a rehearsal of a smoke cell
(everything but the look for a card) with the serving path broken
underneath reads ``correct`` false, once for each fault a one-card
serving cell can have. (A cell on one card has no exchange between
chips to leave out.)"""

import os
import sys

import pytest

from portbench import run as run_mod
from portbench.tests.smoke import add_smoke_cells, make_checkout


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    root = make_checkout(tmp_path_factory.mktemp("faults"))
    add_smoke_cells(root, min_tokens=10**6)   # judge every finished request
    return root


def rehearse(root, monkeypatch, loop="closed", seed=2**31 + 1):
    for var in ("TORCH_EXTENSIONS_DIR", "TRITON_CACHE_DIR", "CUDA_CACHE_PATH",
                "REPRO_TORCH_TUNING_CACHE"):
        monkeypatch.setenv(var, os.environ.get(var, ""))
    monkeypatch.setattr(sys, "path", list(sys.path))
    code, result, _ = run_mod.execute(run_mod.parse(
        ["--workload", f"granite-smoke.{loop}", "--seed", str(seed),
         "--seconds", "3", "--trace", "0", "--rehearse"]), root=root)
    assert code == 0
    return result


@pytest.mark.parametrize("loop", ["closed", "open"])
def test_sound_path_is_correct(checkout, monkeypatch, loop):
    result = rehearse(checkout, monkeypatch, loop)
    assert result["correct"] is True
    assert result["checks"]["max_gap"]["value"] <= 1e-3


def test_a_step_that_leaves_its_state_unchanged(checkout, monkeypatch):
    """The K/V rows never written into the page pool."""
    from repro_torch.serve import paged
    monkeypatch.setattr(paged, "write_rows", lambda *a, **k: None)
    assert rehearse(checkout, monkeypatch)["correct"] is False


def test_half_of_the_batch_left_out(checkout, monkeypatch):
    """The decode step's second half of the slots given the first
    half's picks."""
    from repro_torch.serve.engine import ServingEngine
    step = ServingEngine._decode_step

    def half(self, active):
        nxt = step(self, active)
        h = len(nxt) // 2
        nxt[h:] = nxt[:len(nxt) - h]
        return nxt

    monkeypatch.setattr(ServingEngine, "_decode_step", half)
    assert rehearse(checkout, monkeypatch)["correct"] is False


def test_a_token_altered_where_it_is_produced(checkout, monkeypatch):
    from repro_torch.serve.engine import ServingEngine
    record = ServingEngine._record

    def alter(self, i, req, tok):
        if len(req.generated) == 1:          # each request's second token
            tok = (tok + 1) % self.cfg.vocab
        return record(self, i, req, tok)

    monkeypatch.setattr(ServingEngine, "_record", alter)
    assert rehearse(checkout, monkeypatch, "open")["correct"] is False
