"""The benchmark's traffic: a frozen copy of the port's seeded generator
(``repro_torch/serve/traffic.py``: ``TrafficClass``, ``TrafficConfig``,
``TrafficGenerator``), with arrivals due in wall seconds instead of engine
ticks, so that a slower engine is offered the same load per second.

The copy keeps the original's streams: one ``np.random.default_rng``
draws gaps, classes, log-uniform lengths and prompt tokens, and a
separate stream draws session prefixes. On top of it ``Mix`` builds what a
run offers from a traffic file:

* the request shapes (gap, prompt length, output length) come in rounds of
  ``round`` requests drawn once from the file's ``pool_seed``: every run
  seed gets the same set of sizes and arrivals, each round in another
  order (requests and Poisson gaps permuted apart; a bursty process keeps
  its gaps in order), so a seed changes the order and the tokens, not the
  work;
* prompt tokens come from the run's seed.

A closed loop takes requests in that order as its clients ask for them;
an open loop submits each when it is due, ``arrival_s`` after the start.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class TrafficClass:
    """One tenant class's share of the offered load; lengths are drawn
    log-uniform in [lo, hi]. ``sessions`` > 0 keeps that many session
    prefixes of ``prefix_len`` tokens, one prepended to each arrival."""

    name: str
    weight: float = 1.0
    prompt_lo: int = 8
    prompt_hi: int = 64
    out_lo: int = 4
    out_hi: int = 32
    sessions: int = 0
    prefix_len: int = 0

    def __post_init__(self):
        if not self.weight > 0:
            raise ValueError(f"class {self.name}: weight {self.weight}")
        if not (1 <= self.prompt_lo <= self.prompt_hi
                and 1 <= self.out_lo <= self.out_hi):
            raise ValueError(f"class {self.name}: bad length ranges")
        if self.sessions < 0 or self.prefix_len < 0 or \
                (self.sessions > 0) != (self.prefix_len > 0):
            raise ValueError(f"class {self.name}: session mode needs both "
                             f"sessions and prefix_len")


@dataclasses.dataclass(frozen=True)
class TrafficConfig:
    """Seeded arrival process; ``rate`` in requests a second (the calm
    state's, for the two-state bursty process)."""

    rate: float
    n_requests: int
    seed: int = 0
    process: str = "poisson"          # "poisson" | "bursty"
    burst_factor: float = 8.0
    p_enter_burst: float = 0.05
    p_exit_burst: float = 0.25
    classes: Tuple[TrafficClass, ...] = (TrafficClass("default"),)
    vocab: int = 128                  # prompt token ids in [2, vocab)
    max_prompt: Optional[int] = None

    def __post_init__(self):
        if not self.rate > 0 or self.n_requests < 1:
            raise ValueError(f"rate {self.rate}, n_requests "
                             f"{self.n_requests}")
        if self.process not in ("poisson", "bursty"):
            raise ValueError(f"process {self.process!r}")
        if not (self.burst_factor >= 1.0 and 0.0 < self.p_enter_burst < 1.0
                and 0.0 < self.p_exit_burst <= 1.0 and self.classes):
            raise ValueError("bad burst parameters or no classes")


@dataclasses.dataclass(frozen=True)
class Arrival:
    """One offered request: due ``arrival_s`` seconds after the start."""

    arrival_s: float
    rid: int
    rclass: str
    prompt: np.ndarray
    max_new: int
    session_id: Optional[int] = None


class TrafficGenerator:
    """Deterministic arrival synthesis (one RNG, one seed), the port's
    draw for draw with times in seconds."""

    def __init__(self, cfg: TrafficConfig):
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed)
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
        """The full offered trace, in arrival order."""
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
                pool = self._session_prefixes[cls.name]
                sid = int(self._session_rng.integers(0, cls.sessions))
                prompt = np.concatenate([pool[sid], prompt])
                if cfg.max_prompt is not None:
                    prompt = prompt[:cfg.max_prompt]
            out.append(Arrival(
                arrival_s=t, rid=rid0 + n, rclass=cls.name, prompt=prompt,
                max_new=self._log_uniform(cls.out_lo, cls.out_hi),
                session_id=sid))
        return out


# ----------------------------------------------------------------------------
# What a run offers, from a traffic file
# ----------------------------------------------------------------------------

def classes_of(spec: dict) -> Tuple[TrafficClass, ...]:
    """The traffic file's classes: its ``classes`` list, or one default
    class from ``prompt`` / ``output`` ranges and ``sessions`` /
    ``prefix_len``."""
    if "classes" in spec:
        return tuple(TrafficClass(**c) for c in spec["classes"])
    (plo, phi), (olo, ohi) = spec["prompt"], spec["output"]
    return (TrafficClass("default", prompt_lo=plo, prompt_hi=phi,
                         out_lo=olo, out_hi=ohi,
                         sessions=spec.get("sessions", 0),
                         prefix_len=spec.get("prefix_len", 0)),)


class Mix:
    """The requests one run offers: rounds of ``spec["round"]`` shapes
    drawn once from ``spec["pool_seed"]`` by the copied generator, each
    round's order and every prompt's tokens drawn from the run's
    ``seed``. ``rate`` (requests a second) overrides the file's, as the
    knee sweep does."""

    def __init__(self, spec: dict, seed: int, vocab: int,
                 rate: Optional[float] = None):
        self.spec, self.seed, self.vocab = spec, int(seed), int(vocab)
        self.closed = spec["loop"] == "closed"
        self.rate = float(rate if rate is not None else spec.get("rate")
                          or 1.0)
        self.round = int(spec.get("round", 64))
        self.classes = classes_of(spec)
        pool_cfg = TrafficConfig(
            rate=self.rate, n_requests=self.round,
            seed=int(spec.get("pool_seed", 0)),
            process=spec.get("process", "poisson"),
            burst_factor=spec.get("burst_factor", 8.0),
            p_enter_burst=spec.get("p_enter_burst", 0.05),
            p_exit_burst=spec.get("p_exit_burst", 0.25),
            classes=self.classes, vocab=self.vocab,
            max_prompt=spec.get("max_prompt"))
        self.bursty = pool_cfg.process == "bursty"
        gen = TrafficGenerator(pool_cfg)
        pool = gen.arrivals()
        times = np.asarray([a.arrival_s for a in pool])
        self.gaps = np.diff(np.concatenate([[0.0], times]))
        self.shapes = [(a.rclass, len(a.prompt), a.max_new, a.session_id)
                       for a in pool]
        self._heads = gen._session_prefixes      # the session streams' heads
        self._round_rng: Dict[int, tuple] = {}

    def _shuffle(self, rng) -> np.ndarray:
        """An order of one round: each block of ``shuffle_block``
        consecutive entries permuted within itself (the whole round by
        default), so that every stretch of the offered time carries the
        same work whatever the seed."""
        block = int(self.spec.get("shuffle_block", self.round))
        idx = np.arange(self.round)
        for b0 in range(0, self.round, block):
            idx[b0:b0 + block] = b0 + rng.permutation(
                min(block, self.round - b0))
        return idx

    def _order(self, r: int):
        """Round ``r``'s request order and gap order, and its token
        stream, all from the run's seed."""
        if r not in self._round_rng:
            rng = np.random.default_rng([self.seed, 0xB3, r])
            reqs = self._shuffle(rng)
            gaps = np.arange(self.round) if self.bursty \
                else self._shuffle(rng)
            self._round_rng[r] = (reqs, gaps, rng)
        return self._round_rng[r]

    def arrivals(self) -> Iterator[Arrival]:
        """Requests in offered order, without end; ``arrival_s`` counts
        from the start (rounds back to back; a closed loop ignores it)."""
        t, i = 0.0, 0
        while True:
            r, j = divmod(i, self.round)
            reqs, gaps, rng = self._order(r)
            rclass, plen, max_new, sid = self.shapes[int(reqs[j])]
            t += float(self.gaps[int(gaps[j])])
            prompt = rng.integers(2, self.vocab, size=(plen,),
                                  dtype=np.int64).astype(np.int32)
            if sid is not None:
                head = self._heads[rclass][sid]
                prompt = np.concatenate([head, prompt[len(head):]]) \
                    if len(head) < plen else head[:plen].copy()
            yield Arrival(arrival_s=t, rid=i, rclass=rclass, prompt=prompt,
                          max_new=int(max_new), session_id=sid)
            i += 1

    def take(self, n: int) -> List[Arrival]:
        it = self.arrivals()
        return [next(it) for _ in range(n)]
