"""Deterministic fault injection for the serving engine (port of
``repro/serve/faults.py``).

A scheduled injector wraps a live engine and drives each failure mode on
fixed tick windows, so that pool exhaustion, accept-rate collapse, torn
tuning-cache reads and preemption churn are exercised the same way in
every run (same schedule and traffic, same engine decisions).

Faults:

* ``POOL_SQUEEZE`` — allocate pages to a *phantom* slot id that no engine
  slot owns, shrinking the pool's free list under the scheduler (a
  co-tenant taking device memory). The window's end frees the phantom
  slot; the engine's admission holds, preemptions and degradation latch
  are the response.
* ``ACCEPT_COLLAPSE`` — wrap the engine's draft source so every proposed
  token is off by one (``(tok + 1) % vocab``): drafts stop landing and
  the accept rate collapses, and the adaptive width
  (``spec_adapt_every``) must turn speculation off (and, with
  ``spec_probe_every``, back on once the window ends). Emitted tokens are
  untouched: the verify step corrects every wrong draft.
* ``CACHE_TORN`` — truncate the port's tuning-cache file
  (``core.autotune.TUNING_CACHE_PATH``, or the injector's ``cache_path``)
  in the middle of its JSON, as a torn concurrent write would.
  ``autotune._load_tuning_cache`` must discard it and carry on with the
  defaults, never crash; the window's end writes the original bytes
  back.
* ``SLOT_CHURN`` — preempt one victim slot a tick through the engine's
  own victim policy: a preemption storm that the storm guard
  (``preempt_cooldown``) and the cap (``max_preemptions``) must keep live
  and bounded.

Scheduling is in engine ticks: each ``Fault`` is a [start, stop) window;
``FaultInjector.step(engine)`` is called once a tick, before
``engine.tick()`` (as ``traffic.run_open_loop`` does), and arms and
disarms windows as the clock passes them; ``injected``/``cleared`` count
them.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional

import numpy as np

# Phantom pool tenant: PageAllocator keys slot_pages by any id, so a
# negative id holds pages without colliding with an engine slot (and has
# no row in the engine's page table).
PHANTOM_SLOT = -0xFA117


class _CorruptingDraft:
    """Draft-source proxy that breaks every proposal by one token id. The
    verify step still scores and corrects each position, so the emitted
    stream equals the fault-free engine's: the fault collapses the accept
    rate, not correctness."""

    def __init__(self, inner, vocab: int):
        self._inner = inner
        self._vocab = vocab
        # A windowed drafter's ``window`` bounds the history the engine
        # materialises; forward it.
        window = getattr(inner, "window", None)
        if window is not None:
            self.window = window

    def propose(self, history, k):
        prop = np.asarray(self._inner.propose(history, k), np.int64)
        return ((prop + 1) % self._vocab).astype(np.int32)


@dataclasses.dataclass
class Fault:
    """One scheduled fault window [start, stop) in engine ticks."""

    kind: str                 # one of FaultInjector's kinds
    start: int
    stop: int
    pages: int = 0            # POOL_SQUEEZE: pages to hold (0 -> all
    # free pages above a 2-page floor, re-squeezed every tick)
    min_free: int = 2         # POOL_SQUEEZE floor (pages=0 mode)
    victims_per_tick: int = 1  # SLOT_CHURN: preemptions a tick
    active: bool = False

    def __post_init__(self):
        assert self.kind in (FaultInjector.POOL_SQUEEZE,
                             FaultInjector.ACCEPT_COLLAPSE,
                             FaultInjector.CACHE_TORN,
                             FaultInjector.SLOT_CHURN), self.kind
        assert 0 <= self.start < self.stop, (self.start, self.stop)


class FaultInjector:
    """Arms and disarms a schedule of ``Fault`` windows against one
    engine. Deterministic: fixed tick windows, exact page counts, a pure
    draft corruption, and churn victims from the engine's own victim
    policy."""

    POOL_SQUEEZE = "pool_squeeze"
    ACCEPT_COLLAPSE = "accept_collapse"
    CACHE_TORN = "cache_torn"
    SLOT_CHURN = "slot_churn"

    def __init__(self, schedule: List[Fault],
                 cache_path: Optional[str] = None):
        self.schedule = list(schedule)
        self.injected = 0             # windows armed
        self.cleared = 0              # windows disarmed
        self._saved_draft = None
        self._cache_path = cache_path
        self._cache_bytes: Optional[bytes] = None

    # -- individual faults ----------------------------------------------------

    def _squeeze(self, engine, fault: Fault) -> None:
        pool = engine.pool
        if pool is None:
            return
        if fault.pages:
            held = len(pool.slot_pages.get(PHANTOM_SLOT, ()))
            n = min(fault.pages - held, pool.free_pages)
        else:
            n = pool.free_pages - fault.min_free
        if n > 0:
            pool.alloc(PHANTOM_SLOT, n)

    def _release(self, engine) -> None:
        if engine.pool is not None and \
                PHANTOM_SLOT in engine.pool.slot_pages:
            engine.pool.free_slot(PHANTOM_SLOT)

    def _corrupt_draft(self, engine) -> None:
        if getattr(engine, "draft", None) is not None and \
                self._saved_draft is None:
            self._saved_draft = engine.draft
            engine.draft = _CorruptingDraft(engine.draft,
                                            engine.cfg.vocab)

    def _restore_draft(self, engine) -> None:
        if self._saved_draft is not None:
            engine.draft = self._saved_draft
            self._saved_draft = None

    def _tear_cache(self) -> None:
        from repro_torch.core import autotune
        path = self._cache_path or autotune.TUNING_CACHE_PATH
        if not os.path.exists(path):
            return
        with open(path, "rb") as f:
            data = f.read()
        if self._cache_bytes is None:
            self._cache_bytes = data
        with open(path, "wb") as f:
            f.write(data[:max(1, len(data) // 2)])   # cut mid-JSON
        # The parsed copy in memory would hide the torn file: re-read.
        autotune._tuning_cache = None

    def _heal_cache(self) -> None:
        from repro_torch.core import autotune
        path = self._cache_path or autotune.TUNING_CACHE_PATH
        if self._cache_bytes is not None:
            with open(path, "wb") as f:
                f.write(self._cache_bytes)
            self._cache_bytes = None
            autotune._tuning_cache = None

    def _churn(self, engine, fault: Fault) -> None:
        for _ in range(fault.victims_per_tick):
            victims = [i for i, s in enumerate(engine.slots)
                       if s is not None and i not in engine._prefilling]
            if not victims:
                return
            engine._preempt(engine._choose_victim(victims))

    # -- the tick hook --------------------------------------------------------

    def step(self, engine) -> None:
        """Advance the schedule to ``engine.ticks`` (call once a tick,
        before ``engine.tick()``)."""
        t = engine.ticks
        for fault in self.schedule:
            starting = fault.start <= t < fault.stop
            if starting and not fault.active:
                fault.active = True
                self.injected += 1
                if fault.kind == self.ACCEPT_COLLAPSE:
                    self._corrupt_draft(engine)
                elif fault.kind == self.CACHE_TORN:
                    self._tear_cache()
            elif not starting and fault.active:
                fault.active = False
                self.cleared += 1
                if fault.kind == self.POOL_SQUEEZE:
                    self._release(engine)
                elif fault.kind == self.ACCEPT_COLLAPSE:
                    self._restore_draft(engine)
                elif fault.kind == self.CACHE_TORN:
                    self._heal_cache()
            if fault.active:
                # Per-tick actions: the squeeze re-takes pages freed by
                # finishing slots; churn evicts fresh victims.
                if fault.kind == self.POOL_SQUEEZE:
                    self._squeeze(engine, fault)
                elif fault.kind == self.SLOT_CHURN:
                    self._churn(engine, fault)

    def finish(self, engine) -> None:
        """Disarm everything (cleanup at the end of a run, even when the
        schedule's windows reach past its last tick)."""
        for fault in self.schedule:
            if fault.active:
                fault.active = False
                self.cleared += 1
        self._release(engine)
        self._restore_draft(engine)
        self._heal_cache()


def canonical_schedule(t0: int = 6, dwell: int = 10,
                       gap: int = 8) -> List[Fault]:
    """Pool exhaustion, then accept collapse, then a churn storm:
    sequential windows with recovery gaps, so each fault's clearing is
    exercised too. (``CACHE_TORN`` is scheduled apart, by callers that own
    a tuning cache of their own.)"""
    k = FaultInjector
    w = [(k.POOL_SQUEEZE, t0), (k.ACCEPT_COLLAPSE, t0 + dwell + gap),
         (k.SLOT_CHURN, t0 + 2 * (dwell + gap))]
    return [Fault(kind=kind, start=s, stop=s + dwell) for kind, s in w]
