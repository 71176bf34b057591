"""One cell's run: find its files by name, build the served model and the
engine, drive the traffic for the window and keep what the metrics read.

The window drives ``ServingEngine.submit`` and ``ServingEngine.tick``
alone. After every tick the harness stamps each new token of every live
request with the host clock: a tick returns only after the tokens it
emits are on the host (the decode step and a prompt's last chunk read
their picks back), so the stamp is when the token reached the host. An
open loop's request is timed from when it was due, a closed loop's from
when its client sent it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np

from portbench import traffic as traffic_mod

ROOT = Path(__file__).resolve().parents[1]


# ----------------------------------------------------------------------------
# The cell's files, found by name
# ----------------------------------------------------------------------------

@dataclasses.dataclass
class Cell:
    """A workload of ``BENCHMARK.json`` with its configuration file, its
    traffic file and the metrics it reports."""

    name: str
    workload: dict
    config: dict
    spec: dict
    end_to_end: List[dict]
    per_layer: List[dict]

    @property
    def model(self) -> dict:
        return self.config["port_config"]


def _reports(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The workload ``name`` of ``root/BENCHMARK.json``, its config file
    (the ``file`` of its configuration) and its traffic file
    (``portbench/traffic/<name>.json``)."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json "
                         f"(there are {sorted(work)})")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    return Cell(
        name=name, workload=w,
        config=json.loads((root / conf["file"]).read_text()),
        spec=json.loads((root / "portbench" / "traffic"
                         / f"{name}.json").read_text()),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)])


def reader(name: str, root: Path = ROOT) -> Callable:
    """``read(run)`` of ``portbench/metrics/<name>.py``."""
    path = root / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# ----------------------------------------------------------------------------
# Building the served model
# ----------------------------------------------------------------------------

def build_engine(cell: Cell, params, device, telemetry: bool):
    """The port's engine as its serve launcher builds it: the config
    file's model, greedy, every step a captured CUDA graph on the card,
    ``eos_id`` -1 so that each request runs to its drawn ``max_new``."""
    from repro_torch.configs import ModelConfig
    from repro_torch.serve.engine import ServeConfig, ServingEngine

    cfg = ModelConfig(name=cell.config["name"], **{
        k: tuple(v) if isinstance(v, list) else v
        for k, v in cell.model.items()})
    e = cell.spec["engine"]
    scfg = ServeConfig(
        max_len=e["max_len"], batch=e["batch"],
        temperature=e.get("temperature", 0.0), eos_id=-1,
        paged=e.get("paged", False), page_size=e.get("page_size", 16),
        n_pages=e.get("n_pages"), chunk_size=e.get("chunk"),
        telemetry=telemetry, trace_capacity=1 << 18 if telemetry else 4096)
    return ServingEngine(params, cfg, scfg, device=device, capture=True)


# ----------------------------------------------------------------------------
# Driving the traffic
# ----------------------------------------------------------------------------

@dataclasses.dataclass
class Rec:
    """What the harness saw of one request."""

    rid: int
    prompt: np.ndarray
    due: float                    # when it was due (open) or sent (closed)
    submit_t: float
    req: object = None            # the engine's Request
    times: List[float] = dataclasses.field(default_factory=list)
    done_t: Optional[float] = None
    outcome: Optional[str] = None

    @property
    def first_t(self) -> Optional[float]:
        return self.times[0] if self.times else None


class Driver:
    """Submits a cell's traffic to the engine and stamps what comes back.

    ``hooks`` are called after every tick with its decode rows, (rid,
    context rows) each. ``annotate`` wraps the harness's phases (a
    profiler's ``record_function``) when given."""

    def __init__(self, engine, mix: traffic_mod.Mix, spec: dict,
                 clock=time.perf_counter):
        from repro_torch.serve.engine import Request
        self._Request = Request
        self.engine, self.mix, self.spec, self.clock = engine, mix, spec, clock
        self.closed = mix.closed
        self.recs: Dict[int, Rec] = {}
        self.live: Dict[int, Rec] = {}
        self.source = mix.arrivals()
        self.pending: Optional[traffic_mod.Arrival] = None
        self.start_t: Optional[float] = None
        self.late: List[float] = []   # open loop: submit - due, seconds
        self.hooks: List[Callable] = []
        self.annotate = None
        self.stop_submitting = False

    def _submit(self, arr: traffic_mod.Arrival, due: float,
                max_new: Optional[int] = None) -> None:
        now = self.clock()
        req = self._Request(rid=arr.rid, prompt=arr.prompt,
                            max_new=max_new or arr.max_new)
        rec = Rec(rid=arr.rid, prompt=arr.prompt, due=due, submit_t=now,
                  req=req)
        self.recs[arr.rid] = self.live[arr.rid] = rec
        self.engine.submit(req)

    def start(self) -> None:
        """Open the traffic: a closed loop's clients each send a request,
        client c's first one asking for (c + 1) / clients of its drawn
        tokens, so that the first wave ends spread out; an open loop's
        clock starts."""
        self.start_t = self.clock()
        if self.closed:
            n = int(self.spec["clients"])
            for c in range(n):
                arr = next(self.source)
                self._submit(arr, self.start_t,
                             max(1, round(arr.max_new * (c + 1) / n)))

    def _submit_due(self) -> None:
        now = self.clock()
        while True:
            if self.pending is None:
                self.pending = next(self.source)
            due = self.start_t + self.pending.arrival_s
            if due > now:
                return
            self._submit(self.pending, due)
            self.late.append(self.clock() - due)
            self.pending = None

    def next_due(self) -> float:
        if self.pending is None:
            self.pending = next(self.source)
        return self.start_t + self.pending.arrival_s

    def step(self, until: float) -> float:
        """One tick (open loop: after submitting every request due; idle,
        a wait for the next one, up to ``until``). Returns the time the
        step ended."""
        ann = self.annotate or (lambda name: contextlib.nullcontext())
        if not self.closed and not self.stop_submitting:
            self._submit_due()
            if not self.live:
                with ann("portbench.wait"):
                    wake = min(self.next_due(), until)
                    while self.clock() < wake:
                        time.sleep(max(0.0, min(1e-3, wake - self.clock())))
                return self.clock()
        before = {rid: len(r.req.generated) for rid, r in self.live.items()}
        with ann("portbench.tick"):
            self.engine.tick()
        now = self.clock()
        with ann("portbench.observe"):
            self._observe(before, now)
        return now

    def _observe(self, before: Dict[int, int], now: float) -> None:
        decode_rows = []
        for rid, n0 in before.items():
            rec = self.live[rid]
            req = rec.req
            n = len(req.generated)
            if n > n0:
                rec.times.extend([now] * (n - n0))
                if n0:
                    decode_rows.append((rid, len(rec.prompt) + n0))
            if req.done:
                rec.done_t = now
                rec.outcome = self.engine.outcome.get(rid, "done")
                del self.live[rid]
                if self.closed and not self.stop_submitting:
                    self._submit(next(self.source), self.clock())
        for hook in self.hooks:
            hook(decode_rows)

    def run_ticks(self, n: int) -> None:
        for _ in range(n):
            self.step(float("inf"))

    def run_for(self, seconds: float) -> float:
        """Steps until ``seconds`` have passed; returns the end time (the
        end of the step that crossed it)."""
        end = self.clock() + seconds
        now = self.clock()
        while now < end:
            now = self.step(end)
        return now

    def drain(self, limit_s: float = 600.0) -> None:
        """Stop submitting and tick until every submitted request ended."""
        self.stop_submitting = True
        end = self.clock() + limit_s
        while self.live and self.clock() < end:
            self.step(float("inf"))


# ----------------------------------------------------------------------------
# What the readers read
# ----------------------------------------------------------------------------

@dataclasses.dataclass
class Run:
    """One run, as the metric readers see it (``metrics/<name>.py``)."""

    cell: Cell
    setup_s: float
    t0: float                       # window start (host clock)
    t1: float                       # window end
    recs: Dict[int, Rec]
    esize: int                      # bytes of an element of the served dtype
    counters0: Dict[str, float] = dataclasses.field(default_factory=dict)
    counters1: Dict[str, float] = dataclasses.field(default_factory=dict)
    spans0: Dict[str, dict] = dataclasses.field(default_factory=dict)
    spans1: Dict[str, dict] = dataclasses.field(default_factory=dict)
    pool_use: List[float] = dataclasses.field(default_factory=list)
    profile: Optional[object] = None   # tracer.Profile of the traced slice

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0

    def token_times(self):
        """Every output token's stamp."""
        for r in self.recs.values():
            yield from r.times

    def due_in_window(self) -> List[Rec]:
        return [r for r in self.recs.values() if self.t0 <= r.due < self.t1]

    def itl_gaps(self) -> List[float]:
        """Every gap between consecutive tokens of a request, both inside
        the window."""
        out = []
        for r in self.recs.values():
            ts = [t for t in r.times if self.t0 < t <= self.t1]
            out.extend(b - a for a, b in zip(ts, ts[1:]))
        return out


def engine_counters(engine) -> Dict[str, float]:
    c = dict(engine.telemetry.counters)
    c.update(decode_steps=engine.decode_steps, chunk_steps=engine.chunk_steps,
             ticks=engine.ticks, preemptions=engine.preemptions)
    return c
