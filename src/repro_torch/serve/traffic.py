"""Open-loop traffic generation and SLO accounting for the serving engine
(port of ``repro/serve/traffic.py``).

A closed request list lets the engine set the pace, so its overload
paths never fire. Open-loop arrivals come on their own clock whether or
not the server keeps up: offered load past capacity, where queues grow,
admission sheds and preemption churns.

Everything is deterministic from ``TrafficConfig.seed``: arrivals, prompt
content, length mixes and class labels come from the same
``np.random.default_rng`` streams as the reference's, so the two packages
offer the same arrivals from the same seed.

* ``TrafficClass`` — one tenant class's mix weight, length distributions
  and the name of its engine-side ``SLOClass``.
* ``TrafficGenerator`` — seeded arrival times and requests:
  ``process="poisson"`` draws exponential gaps at ``rate`` requests a
  tick; ``process="bursty"`` is a two-state Markov-modulated Poisson
  process (calm and burst states, seeded flips).
* ``run_open_loop`` — submit every request whose arrival time has passed,
  then tick once, repeat; the engine never gates the generator.
* ``write_log`` / ``replay_log`` — the recorded log format (JSONL, one
  line a request: ``arrival_s``, ``class``, ``prompt_len``, ``max_new``,
  ``session_id``) and its replayer.
* ``summarize`` — the operator's rollup: TTFT/TPOT percentiles (tick
  domain), goodput, shed and preemption accounting, per-class SLO
  attainment, milliseconds from the measured tick time, and wall-clock
  TTFT, queue-wait and prefill-wait tails from the requests' stamps.

Times are in engine ticks (one decode step for every active slot), which
are deterministic and the same on every machine; the measured tick time
turns them into milliseconds.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.serve import engine as engine_mod


@dataclasses.dataclass(frozen=True)
class TrafficClass:
    """One tenant class's share of the offered load.

    ``name`` should match an engine-side ``SLOClass`` name when the
    engine runs with admission classes (unknown names serve unmetered at
    priority 0 — the engine's explicit fallback). Lengths are drawn
    log-uniform in [lo, hi]: production prompt lengths are heavy-tailed,
    and a log draw exercises every bucket/chunk regime instead of
    clustering at the mean."""

    name: str
    weight: float = 1.0               # mix share (normalized over classes)
    prompt_lo: int = 8
    prompt_hi: int = 64
    out_lo: int = 4
    out_hi: int = 32
    # Wall-clock SLO targets (milliseconds), reported by ``summarize``
    # when the engine carries measured tick times (``serve.telemetry``).
    # Tick-domain targets (engine ``SLOClass``) remain the default: they
    # are deterministic and hardware-independent; these price the same
    # latencies on the machine actually serving.
    ttft_ms: Optional[float] = None
    tpot_ms: Optional[float] = None
    # Session mode (multi-turn arrivals that share prefixes). With
    # ``sessions > 0`` the class keeps a pool of that many distinct
    # session prefixes, each ``prefix_len`` tokens; every arrival picks a
    # session (seeded uniform) and prepends its prefix to a fresh
    # log-uniform suffix: returning users re-offer the same opening
    # tokens, the traffic ``ServeConfig.prefix_cache`` serves from
    # shared pages. The prefix pool draws from a *separate* seeded
    # stream, so arrival times, classes and suffixes are bit-identical
    # to the same config with sessions off; only the prompt heads change.
    sessions: int = 0
    prefix_len: int = 0

    def __post_init__(self):
        assert self.weight > 0, self.weight
        assert 1 <= self.prompt_lo <= self.prompt_hi
        assert 1 <= self.out_lo <= self.out_hi
        assert self.ttft_ms is None or self.ttft_ms > 0
        assert self.tpot_ms is None or self.tpot_ms > 0
        assert self.sessions >= 0 and self.prefix_len >= 0
        assert (self.sessions > 0) == (self.prefix_len > 0), \
            "session mode needs both sessions and prefix_len"


@dataclasses.dataclass(frozen=True)
class TrafficConfig:
    """Seeded open-loop arrival process.

    ``rate`` is offered load in requests per engine tick. The bursty
    process alternates calm (``rate``) and burst (``rate * burst_factor``)
    states; state flips are Bernoulli per arrival with the given exit
    probabilities, giving geometric dwell times — the standard 2-state
    MMPP shape."""

    rate: float                       # mean arrivals per tick (calm state)
    n_requests: int                   # total requests to offer
    seed: int = 0
    process: str = "poisson"          # "poisson" | "bursty"
    burst_factor: float = 8.0         # burst-state rate multiplier
    p_enter_burst: float = 0.05       # calm -> burst flip per arrival
    p_exit_burst: float = 0.25        # burst -> calm flip per arrival
    classes: Tuple[TrafficClass, ...] = (TrafficClass("default"),)
    vocab: int = 128                  # prompt token id range [2, vocab)
    max_prompt: Optional[int] = None  # clamp (engine max_len guard)

    def __post_init__(self):
        assert self.rate > 0, self.rate
        assert self.n_requests >= 1
        assert self.process in ("poisson", "bursty"), self.process
        assert self.burst_factor >= 1.0
        assert 0.0 < self.p_enter_burst < 1.0
        assert 0.0 < self.p_exit_burst <= 1.0
        assert self.classes


@dataclasses.dataclass(frozen=True)
class Arrival:
    """One offered request: what to submit and when. ``session_id``
    marks a returning user (session-mode classes): arrivals with the
    same id share their prompt head, and the recorded-log format
    carries the id so a replay regenerates the same sharing shape."""

    tick: int                         # arrival time (engine ticks)
    rid: int
    rclass: str
    prompt: np.ndarray
    max_new: int
    session_id: Optional[int] = None


class TrafficGenerator:
    """Deterministic open-loop arrival synthesis (one RNG, one seed)."""

    def __init__(self, cfg: TrafficConfig):
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed)
        # Session prefixes come from a *separate* seeded stream: the
        # main stream draws exactly the same sequence with sessions on
        # or off, so flipping session mode changes prompt heads only —
        # arrival times, class picks, and suffixes stay bit-identical.
        self._session_rng = np.random.default_rng([cfg.seed, 0x5E55])
        self._session_prefixes: Dict[str, np.ndarray] = {}
        for c in cfg.classes:
            if c.sessions:
                self._session_prefixes[c.name] = self._session_rng.integers(
                    2, cfg.vocab, size=(c.sessions, c.prefix_len),
                    dtype=np.int64).astype(np.int32)

    def _log_uniform(self, lo: int, hi: int) -> int:
        if lo == hi:
            return lo
        return int(round(np.exp(self.rng.uniform(np.log(lo), np.log(hi)))))

    def arrivals(self, rid0: int = 0) -> List[Arrival]:
        """The full offered trace, arrival-time sorted."""
        cfg = self.cfg
        names = [c.name for c in cfg.classes]
        weights = np.asarray([c.weight for c in cfg.classes], np.float64)
        weights = weights / weights.sum()
        by_name = {c.name: c for c in cfg.classes}
        out: List[Arrival] = []
        t = 0.0
        burst = False
        for n in range(cfg.n_requests):
            rate = cfg.rate
            if cfg.process == "bursty":
                # Geometric dwell: flip with the state's exit probability
                # before each gap, then draw the gap at the state's rate.
                p = cfg.p_exit_burst if burst else cfg.p_enter_burst
                if self.rng.random() < p:
                    burst = not burst
                if burst:
                    rate = cfg.rate * cfg.burst_factor
            t += self.rng.exponential(1.0 / rate)
            cls = by_name[str(self.rng.choice(names, p=weights))]
            plen = self._log_uniform(cls.prompt_lo, cls.prompt_hi)
            if cfg.max_prompt is not None:
                plen = min(plen, cfg.max_prompt)
            prompt = self.rng.integers(2, cfg.vocab, size=(plen,),
                                       dtype=np.int64).astype(np.int32)
            sid: Optional[int] = None
            if cls.sessions:
                # A returning user: this session's shared opening tokens
                # ahead of the per-arrival suffix (clamped prefix-first —
                # the shared head is what the prefix cache can reuse).
                pool = self._session_prefixes[cls.name]
                sid = int(self._session_rng.integers(0, cls.sessions))
                prompt = np.concatenate([pool[sid], prompt])
                if cfg.max_prompt is not None:
                    prompt = prompt[:cfg.max_prompt]
            out.append(Arrival(
                tick=int(t), rid=rid0 + n, rclass=cls.name, prompt=prompt,
                max_new=self._log_uniform(cls.out_lo, cls.out_hi),
                session_id=sid))
        return out


# ----------------------------------------------------------------------------
# Recorded-log format: write a trace out, replay it back
# ----------------------------------------------------------------------------

LOG_SCHEMA_VERSION = 1


def write_log(path: str, arrivals: List[Arrival]) -> None:
    """Write the offered trace as a recorded production log: JSONL, one
    line per request with ``arrival_s`` (the tick-domain arrival time),
    ``class``, ``prompt_len``, ``max_new``, ``session_id``. Token
    *content* is deliberately not recorded — production logs don't ship
    user text; ``replay_log`` re-synthesizes deterministic tokens at the
    recorded lengths and session-sharing shape."""
    with open(path, "w") as f:
        for a in arrivals:
            f.write(json.dumps({
                "arrival_s": float(a.tick),
                "class": a.rclass,
                "prompt_len": int(len(a.prompt)),
                "max_new": int(a.max_new),
                "session_id": a.session_id,
            }) + "\n")


def replay_log(path: str, vocab: int = 128, seed: int = 0,
               rid0: int = 0, prefix_len: int = 0) -> List[Arrival]:
    """Rebuild a submittable arrival list from a recorded log.

    Prompts are synthesized deterministically from ``seed`` at each
    line's recorded length: lines carrying the same ``session_id`` get
    the same ``prefix_len``-token head (drawn from a per-session seeded
    stream, mirroring the generator's separate session stream), so a
    replayed log re-offers the prefix-sharing the live traffic had —
    the property prefix-cache and calibration runs care about. Replay
    of a replayed log's own recording is bit-identical (round-trip)."""
    rng = np.random.default_rng([seed, 0x10C])
    heads: Dict[int, np.ndarray] = {}
    out: List[Arrival] = []
    with open(path) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            plen = int(rec["prompt_len"])
            sid = rec.get("session_id")
            prompt = rng.integers(2, vocab, size=(plen,),
                                  dtype=np.int64).astype(np.int32)
            if sid is not None and prefix_len > 0:
                if sid not in heads:
                    heads[sid] = np.random.default_rng(
                        [seed, 0x5E55, int(sid)]).integers(
                        2, vocab, size=(prefix_len,),
                        dtype=np.int64).astype(np.int32)
                head = heads[sid][:plen]
                prompt = np.concatenate([head, prompt[len(head):]])
            out.append(Arrival(
                tick=int(rec["arrival_s"]), rid=rid0 + i,
                rclass=str(rec["class"]), prompt=prompt,
                max_new=int(rec["max_new"]),
                session_id=None if sid is None else int(sid)))
    return out


def run_open_loop(engine, arrivals: List[Arrival],
                  max_ticks: int = 20000,
                  injector=None,
                  record_to: Optional[str] = None) -> Dict[str, dict]:
    """Drive ``engine`` open-loop: each iteration submits every arrival
    whose time has passed (the generator's clock, not the engine's
    readiness), then ticks once. Runs until every offered request has a
    terminal outcome (finished or rejected) or ``max_ticks`` elapses —
    the caller asserts on the shortfall, because a request with no
    outcome after the drain window IS the hang the robustness invariant
    forbids. ``injector`` (``serve.faults.FaultInjector``) is stepped
    before each tick so fault schedules share the tick clock.
    ``record_to`` writes the *offered* trace (submission order) in the
    recorded-log format before driving it — what ``replay_log`` reads
    back."""
    pending = sorted(arrivals, key=lambda a: (a.tick, a.rid))
    if record_to is not None:
        write_log(record_to, pending)
    offered = {a.rid for a in pending}
    j = 0
    for _ in range(max_ticks):
        while j < len(pending) and pending[j].tick <= engine.ticks:
            a = pending[j]
            engine.submit(engine_mod.Request(
                rid=a.rid, prompt=a.prompt, max_new=a.max_new,
                rclass=a.rclass))
            j += 1
        if injector is not None:
            injector.step(engine)
        engine.tick()
        if j == len(pending):
            done = all(r in engine.finished or r in engine.rejected
                       for r in offered)
            if done and not engine.queue and \
                    all(s is None for s in engine.slots):
                break
    return {
        "finished": dict(engine.finished),
        "rejected": dict(engine.rejected),
        "unresolved": sorted(
            r for r in offered
            if r not in engine.finished and r not in engine.rejected),
    }


def _pct(xs: List[float], q: float) -> float:
    return float(np.percentile(np.asarray(xs, np.float64), q)) \
        if xs else float("nan")


def summarize(engine, arrivals: List[Arrival],
              classes: Optional[Tuple[TrafficClass, ...]] = None
              ) -> Dict[str, object]:
    """The operator-facing rollup, tick domain first, wall-clock second.

    * TTFT: first-token tick minus submit tick (queueing + prefill).
    * TPOT: inter-token interval over the decode phase,
      (finish - first) / (n_tokens - 1), per request with >= 2 tokens.
    * goodput: completed tokens per elapsed tick — tokens of *finished*
      requests only, so shed/preempted-to-death work doesn't count.
    * per class: the same plus SLO attainment against the engine's
      ``SLOClass`` targets when they are set.
    * wall-clock: when the engine's telemetry measured tick times
      (``serve.telemetry``, default-on), the summary adds the tick-time
      histogram (``tick_wall_s_*``) and millisecond latency percentiles
      (tick-domain latency x mean measured tick). Pass the traffic
      ``classes`` to also report attainment against any ``ttft_ms`` /
      ``tpot_ms`` targets they carry: SLOs priced in milliseconds on
      the machine actually serving, not just in ticks.
    * wall-clock stamps: when the engine stamped its requests (telemetry
      on, ``engine.stamps``), the TTFT from submission to the first token
      recorded (``ttft_wall_ms_p50/p95/p99``), the queue wait from
      submission to the first admission (``queue_wait_ms_p50/p95/p99``)
      and the wait from submission to the first prompt chunk served
      (``prefill_wait_ms_p50/p95/p99``: the queue and, paged, the turns
      other prompts' chunks took first), over the requests that reached
      each, beside the tick-based estimate.
    """
    by_class: Dict[str, List[Arrival]] = {}
    for a in arrivals:
        by_class.setdefault(a.rclass, []).append(a)
    elapsed = max(1, engine.ticks)
    done_tokens = sum(len(v) for r, v in engine.finished.items()
                      if engine.outcome.get(r) == "done")
    all_tokens = sum(len(v) for v in engine.finished.values())
    tel = getattr(engine, "telemetry", None)
    tstats = tel.tick_stats() if tel is not None else {"n": 0}
    # ticks -> milliseconds via the measured mean tick time. None when
    # nothing was measured (telemetry disabled): the ms fields are then
    # simply absent rather than fabricated.
    tick_ms = tstats["mean_s"] * 1e3 if tstats["n"] else None
    wall_cls = {c.name: c for c in (classes or ())}

    stamps = getattr(engine, "stamps", {})
    submitted = stamps.get("submit_t", {})
    walls = (("ttft_wall_ms", stamps.get("first_token_t", {})),
             ("queue_wait_ms", stamps.get("admit_t", {})),
             ("prefill_wait_ms", stamps.get("first_chunk_t", {})))

    def roll(arrs: List[Arrival]) -> Dict[str, object]:
        ttfts, tpots = [], []
        wall: Dict[str, List[float]] = {name: [] for name, _ in walls}
        n_done = n_forced = n_rejected = 0
        ttft_ok = tpot_ok = ttft_n = tpot_n = 0
        ttft_ms_ok = tpot_ms_ok = ttft_ms_n = tpot_ms_n = 0
        for a in arrs:
            cls = engine._classes.get(a.rclass)
            wcls = wall_cls.get(a.rclass)
            out = engine.outcome.get(a.rid, "")
            if out == "done":
                n_done += 1
            elif out.startswith("forced"):
                n_forced += 1
            elif out.startswith("rejected"):
                n_rejected += 1
            for name, at in walls:
                if a.rid in at:
                    wall[name].append(at[a.rid] - submitted[a.rid])
            ft = engine.first_token_tick.get(a.rid)
            sub = engine.submit_tick.get(a.rid)
            if ft is not None and sub is not None:
                ttft = ft - sub
                ttfts.append(ttft)
                if cls is not None and cls.ttft_slo is not None:
                    ttft_n += 1
                    ttft_ok += ttft <= cls.ttft_slo
                if wcls is not None and wcls.ttft_ms is not None \
                        and tick_ms is not None:
                    ttft_ms_n += 1
                    ttft_ms_ok += ttft * tick_ms <= wcls.ttft_ms
            fin = engine.finish_tick.get(a.rid)
            n_tok = len(engine.finished.get(a.rid, ()))
            if ft is not None and fin is not None and n_tok >= 2:
                tpot = (fin - ft) / (n_tok - 1)
                tpots.append(tpot)
                if cls is not None and cls.tpot_slo is not None:
                    tpot_n += 1
                    tpot_ok += tpot <= cls.tpot_slo
                if wcls is not None and wcls.tpot_ms is not None \
                        and tick_ms is not None:
                    tpot_ms_n += 1
                    tpot_ms_ok += tpot * tick_ms <= wcls.tpot_ms
        out = {
            "offered": len(arrs),
            "done": n_done,
            "forced": n_forced,
            "rejected": n_rejected,
            "ttft_p50": _pct(ttfts, 50), "ttft_p99": _pct(ttfts, 99),
            "tpot_p50": _pct(tpots, 50), "tpot_p99": _pct(tpots, 99),
        }
        if ttft_n:
            out["ttft_slo_attainment"] = ttft_ok / ttft_n
        if tpot_n:
            out["tpot_slo_attainment"] = tpot_ok / tpot_n
        if tick_ms is not None:
            out["ttft_ms_p50"] = out["ttft_p50"] * tick_ms
            out["ttft_ms_p99"] = out["ttft_p99"] * tick_ms
            out["tpot_ms_p50"] = out["tpot_p50"] * tick_ms
            out["tpot_ms_p99"] = out["tpot_p99"] * tick_ms
        for name, xs in wall.items():
            if xs:
                for q in (50, 95, 99):
                    out[f"{name}_p{q}"] = _pct(xs, q) * 1e3
        if ttft_ms_n:
            out["ttft_ms_slo_attainment"] = ttft_ms_ok / ttft_ms_n
        if tpot_ms_n:
            out["tpot_ms_slo_attainment"] = tpot_ms_ok / tpot_ms_n
        return out

    summary: Dict[str, object] = roll(arrivals)
    summary.update({
        "ticks": engine.ticks,
        "goodput_tokens_per_tick": done_tokens / elapsed,
        "total_tokens_per_tick": all_tokens / elapsed,
        "shed_rate": sum(engine.shed_by_class.values())
        / max(1, len(arrivals)),
        "preemptions": engine.preemptions,
        "admission_holds": engine.admission_rejections,
        "downshifts": engine.downshifts,
        "degraded_ticks": engine.degraded_ticks,
        "by_class": {name: roll(arrs)
                     for name, arrs in sorted(by_class.items())},
    })
    if tstats["n"]:
        summary.update({
            "wall_s": tstats["total_s"],
            "tick_wall_s_mean": tstats["mean_s"],
            "tick_wall_s_p50": tstats["p50_s"],
            "tick_wall_s_p99": tstats["p99_s"],
        })
    return summary
