"""Continuous-batching serving engine (port of ``repro/serve/engine.py``:
its contiguous mode, its paged core, and the module-level generation loop).

Requests join free slots; each ``tick`` admits, runs prefill, and runs one
batched decode step for every decode-active slot. Two cache layouts:

* **Contiguous** (``ServeConfig(paged=False)``, the default, as in the
  reference): every slot owns ``max_len`` rows of K/V (and its Mamba
  state). Admission prefills one whole prompt per free slot per tick:
  attention stacks pad the prompt to a power-of-two bucket
  (``bucket_for``), SSM stacks prefill at exact length; the prompt runs
  through a fresh batch-1 row cache, which is then installed in the slot.
* **Paged** (``paged=True``): K/V rows live in a shared page pool.

  - **Admission** reserves only the first chunk's pages and leaves
    headroom for what already-admitted slots take this tick; a short pool
    holds the request (it stays queued) instead of failing. A request
    that could not fit even an empty pool raises ``PagePoolExhausted``.
  - **Chunked prefill** writes a prompt in place through the page table,
    ``chunk_size`` rows at a time, on a batch-1 view of the pools.
  - **Preemption**: a pool that runs short evicts a victim slot (least
    progress first, youngest on ties); its pages return to the pool and
    the request re-queues at the head with its generated tokens, which
    are prefilled again as prompt on re-admission.
  - **Prefix caching** (``prefix_cache=True``): every full page of a
    prompt that a chunk completes is published in a ``PrefixIndex``;
    an admission maps the longest cached run of full pages into its
    table (refcounts, no data moved) and prefills only the rest. A write
    that would land in a page another holder reads first copies that
    page (copy-on-write, one ``copy_`` a layer on the device). Pages only
    the index holds are evicted, least recently used first, before a
    hold or a preemption.
  - **Speculative decoding** (``spec_k > 0``): each tick a draft source
    (``serve.spec``) proposes up to ``spec_k`` tokens for every
    decode-active slot, and one verify step of width ``spec_k + 1``
    scores them with the pending token through the paged prefill kernel;
    the longest accepted prefix and the target's next token are emitted,
    and the write positions roll back over the rejected rows. With
    ``spec_adapt_every`` the drafts a slot asks for (``k_live``, at most
    ``spec_k``) are re-chosen from the measured accept rate every that
    many verify ticks (``spec.rechoose_k``); at 0 the engine decodes, and
    with ``spec_probe_every`` a one-draft trial tick every that many
    plain ticks lets a recovered accept rate re-open speculation.

**Cost models** (``core.autotune``): the engine resolves its constants
once (``constants``: calibrated on this device type by ``core.calibrate``
where the tuning cache holds them, the hand-set defaults otherwise), and
prices with them the chunk size when ``chunk_size`` is None
(``choose_prefill_chunk``) and the adaptive draft width.

**Overload** (every knob off by default, as in the reference):

* ``classes`` (``SLOClass``): admission runs highest priority first,
  preempted re-admissions ahead of all, each metered class through a
  debit token bucket; preemption evicts the lowest class first.
* ``max_queue``: beyond this depth the lowest-priority newest fresh
  request is shed (``rejected``, ``shed_by_class``).
* ``max_preemptions``: a request evicted that many times is next
  force-finished with its partial stream (or rejected if it emitted
  nothing); a request over the pool's capacity is rejected, and a lone
  slot short of a decode page preempts itself, instead of raising.
* ``prefill_chunks_per_tick``: a per-tick chunk budget, shortest
  remaining first with an aging term, so a long prompt is not starved.
* ``degrade``: under pressure (``core.autotune.serve_pressure``, with the
  hysteresis of ``choose_degradation``) speculation is shed, the tick
  runs the plain decode step, and the chunk budget drops to 1.

**Telemetry** (``serve.telemetry``): every decision emits a typed event,
and the decision counters (``preemptions``, ``admission_rejections``, the
spec and prefix counters) are views over its aggregates; the phases and
steps of a tick run under wall-clock spans. No synchronisation is added
for it: the decode and verify spans end with the step's read of its
picks, the chunk span with the launch only.

The page table and the per-slot write positions live on the host (numpy)
and are copied into static device buffers before each step: every change
to them is a host decision, so the engine never reads them back.

**Steps.** The decode step (with ``spec_k``, the verify step in its
place; paged, also the chunk step) is a function of those static buffers
(``serve.graphs.Step``). On the card it is captured as one CUDA graph at
construction, while every slot is empty, and each tick replays it: the
counterpart of the reference's jitted executables, counted in
``decode_traces``, ``verify_traces`` and ``prefill_traces`` at a step's
first use, as the reference counts a trace (a speculative engine that
never decodes keeps ``decode_traces`` at 0). A speculative engine that
can decode (with ``degrade``, or with ``spec_adapt_every``, whose
``k_live`` may reach 0) holds both the verify and the decode step; the
verify keeps its ``spec_k + 1`` width whatever ``k_live`` is.
``capture=False`` runs the same functions
eagerly (the counterpart of ``jax.disable_jit``), as the CPU always does;
on the card each step is still run once at construction, so that both
modes start warm. The contiguous prefill stays eager: one graph per
bucket (per length, for SSM stacks) would be replayed once or twice a
run.

**Sampling** (``temperature > 0``, ``serve.sampling``): every emitted
token is drawn under a threefry key folded from (request id, emitted
index), never from the tick, as the reference keys it; so a preempted
and re-admitted stream replays its keys, and a verify draws the keys
sequential decode would. The decode (verify) step folds the rows' (and
positions') keys on the device from static rid and index buffers; a
prompt's first
token (the paged engine's last chunk, the contiguous engine's admission)
takes its key from the host. Greedy folds no key.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import ModelConfig
from repro_torch.core import autotune
from repro_torch.dist import sharding
from repro_torch.models import transformer as T
from repro_torch.serve import dist as serve_dist
from repro_torch.serve import graphs
from repro_torch.serve import paged as paged_mod
from repro_torch.serve import sampling
from repro_torch.serve import spec as spec_mod
from repro_torch.serve import telemetry as telemetry_mod
from repro_torch.serve.sampling import sampler  # noqa: F401 (reference name)


@dataclasses.dataclass(frozen=True)
class SLOClass:
    """One request class and its service-level objectives.

    ``priority`` orders admission (higher first) and preemption (lower
    evicted first). The TTFT/TPOT targets (ticks) are accounting, which
    ``serve.traffic.summarize`` scores. ``rate``/``burst`` meter the
    class's admission token bucket (tokens a tick / bucket cap); a class
    with ``rate=None`` admits unmetered."""

    name: str
    priority: int = 0            # higher = more important
    ttft_slo: Optional[int] = None     # target ticks to first token
    tpot_slo: Optional[float] = None   # target ticks an output token
    rate: Optional[float] = None       # bucket refill, tokens a tick
    burst: Optional[float] = None      # bucket cap; None -> 8 * rate

    @property
    def bucket_cap(self) -> float:
        if self.burst is not None:
            return float(self.burst)
        return 8.0 * float(self.rate or 0.0)


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_len: int
    batch: int
    temperature: float = 0.0     # 0 -> greedy
    eos_id: int = 1
    seed: int = 0                # sampling keys (temperature > 0)
    min_bucket: int = 8          # smallest prefill bucket (power of two)
    paged: bool = False          # K/V rows from a shared page pool
    page_size: int = 16          # rows per page (paged)
    n_pages: Optional[int] = None  # pool incl. null page (paged); None ->
    # the contiguous equivalent, 1 + batch * max_len / page_size
    chunk_size: Optional[int] = None  # prefill chunk rows (paged; a
    # page_size multiple); None: the chunk cost model's choice
    # (``core.autotune.choose_prefill_chunk``)
    spec_k: int = 0              # drafted tokens a verify tick (paged); 0
    # decodes one token a tick. The verify step's width is spec_k + 1.
    draft: Any = None            # spec_k > 0: a draft source, or "ngram"
    # (None), "self", or an arch name (``spec.resolve_draft``)
    spec_adapt_every: Optional[int] = None  # re-choose the drafts a slot
    # asks for (``k_live`` <= spec_k) from the accept rate measured over
    # this many verify ticks (``spec.rechoose_k``); 0 drafts decode. None
    # keeps spec_k
    spec_probe_every: Optional[int] = None  # while k_live is 0, a one-
    # draft trial tick every this many plain ticks, feeding the same
    # window, so speculation can re-open (needs spec_adapt_every). None
    # keeps k_live at 0 once it gets there
    prefix_cache: bool = False   # paged: share full-page prompt prefixes
    # through the page table (``paged.PrefixIndex``)
    prefill_chunks_per_tick: Optional[int] = None  # paged: chunk budget a
    # tick; None runs one chunk for every mid-prefill slot
    # -- overload (all off by default) ---------------------------------------
    classes: Optional[Tuple[SLOClass, ...]] = None  # request classes;
    # ``Request.rclass`` names one (unknown: priority 0, unmetered)
    max_queue: Optional[int] = None  # bounded queue: beyond it, shed
    max_preemptions: Optional[int] = None  # per-request preemption cap
    preempt_cooldown: int = 2    # a slot re-admitted within this many
    # ticks ranks behind its class peers as a victim
    degrade: bool = False        # downshift under pressure (spec off,
    # chunk budget 1), with hysteresis between the two thresholds
    pressure_high: float = 0.85  # enter degraded mode at or above this
    pressure_low: float = 0.60   # leave it at or below this
    # -- observability (``serve.telemetry``) ---------------------------------
    telemetry: bool = True       # event ring and wall-clock spans; off,
    # the decision aggregates stay exact and the streams the same
    trace_capacity: int = 4096   # ring entries a stream (events, spans,
    # tick times)


def _counter_view(key: str, doc: str) -> property:
    """An engine counter as a view over ``telemetry.counters``: readable
    and writable, stored in the telemetry's aggregates, so the event
    trace and the counter cannot disagree."""
    def get(self):
        return self.telemetry.counters.get(key, 0)

    def set_(self, v):
        self.telemetry.counters[key] = int(v)

    return property(get, set_, doc=doc)


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray
    max_new: int
    generated: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    rclass: str = "default"      # SLO class name (ServeConfig.classes)
    preempt_count: int = 0       # times evicted back to the queue
    readmitted_at: Optional[int] = None  # tick of the last re-admission


@torch.no_grad()
def prefill(params, cfg: ModelConfig, tokens, caches, frontend_embeds=None,
            cross_kv=None):
    """Run the prompt through the model, filling the caches. Returns the
    last position's logits and the new caches. ``frontend_embeds`` or
    ``cross_kv``: what the cross layers read (``T.forward``)."""
    logits, caches = T.forward(params, cfg, tokens, caches=caches,
                               frontend_embeds=frontend_embeds,
                               cross_kv=cross_kv)
    return logits[:, -1], caches


@torch.no_grad()
def decode_step(params, cfg: ModelConfig, last_tokens, caches,
                frontend_embeds=None, cross_kv=None):
    """One decode step: (b,) token ids -> (b, vocab) logits + new caches."""
    logits, caches = T.forward(params, cfg, last_tokens[:, None],
                               caches=caches, frontend_embeds=frontend_embeds,
                               cross_kv=cross_kv)
    return logits[:, -1], caches


def make_serve_step(cfg: ModelConfig, temperature: float = 0.0) -> Callable:
    """The decode step as a plain function (the reference jits it):
    ``step(params, last_tokens, caches, key=None, frontend_embeds=None,
    cross_kv=None) -> (next ids, new caches)``. One (2,) key draws the
    whole batch's noise, as the reference's does; greedy reads no key."""
    pick = sampling.sampler(temperature)

    def step(params, last_tokens, caches, key=None, frontend_embeds=None,
             cross_kv=None):
        logits, caches = decode_step(params, cfg, last_tokens, caches,
                                     frontend_embeds=frontend_embeds,
                                     cross_kv=cross_kv)
        return pick(logits, key), caches

    return step


@torch.no_grad()
def greedy_generate(params, cfg: ModelConfig, prompt: torch.Tensor,
                    max_new: int, max_len: Optional[int] = None,
                    frontend_embeds=None):
    """The generation loop the engines are compared with: prompt (b, s)
    on the model's device -> (b, max_new) greedy ids, through contiguous
    caches with one position shared by every row. ``frontend_embeds``
    (b, n, d_model) feeds the cross layers: what they read
    (``T.cross_source``, the encoder's output where there is one) is
    computed once and handed to the prefill and every decode step."""
    b, s = prompt.shape
    max_len = max_len or (s + max_new)
    cross_kv = T.cross_source(params, cfg, frontend_embeds)
    caches = T.init_caches(cfg, b, max_len, device=prompt.device)
    logits, caches = prefill(params, cfg, prompt, caches, cross_kv=cross_kv)
    tok = logits.argmax(-1)
    out = [tok]
    step = make_serve_step(cfg)
    for _ in range(max_new - 1):
        tok, caches = step(params, tok, caches, cross_kv=cross_kv)
        out.append(tok)
    return torch.stack(out, dim=1)


class ServingEngine:
    """Slot-based continuous batching over a fixed decode batch.

    ``capture`` (the default) makes each repeating step one CUDA graph on
    the card; it is not read on the CPU, where steps always run eagerly.

    ``mesh`` (``launch.mesh.make_serving_mesh``, a 1-D ``("model",)``
    mesh over the ranks of an initialised process group) serves
    tensor-parallel, paged only: every rank builds the engine with the
    same full ``params`` and keeps its shard (``dist.sharding.param_spec``
    under ``serve.dist.serve_ruleset``), the page pool is sharded by pages
    over the ranks (``PageAllocator(n_devices=...)``, ``n_pages`` rounded
    up to a multiple of the ranks), and the steps run under the ruleset,
    so the layers run the collectives (``serve.dist``). The host side
    (scheduling, tables, sampling) is the same on every rank and prices
    the global pool, so the streams are those of one rank. A mixture of
    experts serves with its experts split over the mesh (``models.moe``).
    A speculative engine's draft source (a model draft holds the whole
    ``params`` and runs unsharded, ``spec.ModelDraft``) proposes on every
    rank, and rank 0's drafts are broadcast, so every rank verifies the
    same tokens. The collectives
    of a gloo group cannot be captured in a CUDA graph: on the card such
    an engine needs ``capture=False``."""

    def __init__(self, params, cfg: ModelConfig, serve_cfg: ServeConfig,
                 device=None, capture: bool = True, mesh=None):
        self.device = resolve_device(device)
        if cfg.encoder is not None or cfg.n_frontend_tokens:
            # As the reference's engine: its requests carry no frontend.
            raise ValueError(f"{cfg.name}: the serving engine supports "
                             f"decoder-only archs (serve an encoder or a "
                             f"frontend through greedy_generate)")
        self.cfg, self.scfg, self.params = cfg, serve_cfg, params
        self.mesh = mesh
        self._ruleset: Optional[sharding.Ruleset] = None
        self._pool_axis: Optional[str] = None
        self._n_dev = 1
        if mesh is not None:
            self._check_mesh(cfg, serve_cfg, capture)
            self._ruleset = serve_dist.serve_ruleset(mesh)
            self._pool_axis = self._ruleset._rule(serve_dist.POOL_RULE)
            self._n_dev = int(mesh.shape.get(self._pool_axis, 1))
            self.params = serve_dist.shard_params(params, mesh,
                                                  self._ruleset)
        # The constants every choose_* decision of this engine is priced
        # with: calibrated on this device type (and mesh) where the tuning
        # cache has them, the hand-set defaults otherwise.
        self.constants = autotune.resolve_constants(
            mesh_shape=mesh, backend=self.device.type)
        max_len = serve_cfg.max_len
        # Bucketing pads the prompt on the right, which only attention
        # layers mask; SSM stacks carry state through every position, so
        # they prefill at exact length.
        self._bucketed = all(k == "attn" for k in cfg.pattern)
        if serve_cfg.paged:
            if not self._bucketed:
                raise ValueError("paged serving needs an attention-only "
                                 f"stack, not {cfg.pattern}")
            ps, chunk = serve_cfg.page_size, serve_cfg.chunk_size
            if max_len % ps:
                raise ValueError(f"max_len {max_len} is not a multiple of "
                                 f"page_size {ps}")
            if chunk is None:
                chunk, _ = autotune.choose_prefill_chunk(
                    max_len, cfg.n_heads, cfg.n_kv_heads, cfg.dhead, ps,
                    in_bytes=cfg.dtype.itemsize,
                    constants=self.constants)
            if chunk % ps or not 0 < chunk <= max_len:
                raise ValueError(f"chunk_size {chunk} must be a page_size "
                                 f"multiple in (0, max_len]")
            self.chunk: Optional[int] = chunk
            n_pages = serve_cfg.n_pages or 1 + serve_cfg.batch * max_len // ps
            if n_pages % self._n_dev:
                # Equal blocks a rank; rounding up only adds capacity.
                n_pages += self._n_dev - n_pages % self._n_dev
            self.pool: Optional[paged_mod.PageAllocator] = \
                paged_mod.PageAllocator(n_pages, ps, n_devices=self._n_dev)
            self.caches = T.init_paged_caches(cfg, serve_cfg.batch, max_len,
                                              ps, n_pages, device=self.device)
            if mesh is not None:
                self.caches = serve_dist.shard_caches(self.caches, mesh,
                                                      self._pool_axis)
            self.max_pages = max_len // ps
            self.prefix: Optional[paged_mod.PrefixIndex] = \
                paged_mod.PrefixIndex(self.pool) if serve_cfg.prefix_cache \
                else None
        else:
            if serve_cfg.spec_k or serve_cfg.prefix_cache:
                raise ValueError("speculative decoding and prefix caching "
                                 "need paged=True")
            self.prefix = None
            self.chunk = None
            self.pool = None
            self.caches = T.init_caches(cfg, serve_cfg.batch, max_len,
                                        per_slot_index=True,
                                        device=self.device)
            self.max_pages = 0
        # Host copies of the page table and the write positions.
        self.pages = np.zeros((serve_cfg.batch, self.max_pages), np.int32)
        self.index = np.zeros((serve_cfg.batch,), np.int32)
        self.last_tok = np.zeros((serve_cfg.batch,), np.int64)
        self.slots: List[Optional[Request]] = [None] * serve_cfg.batch
        self.queue: List[Request] = []
        self.finished: Dict[int, List[int]] = {}
        self.ticks = 0
        self.first_token_tick: Dict[int, int] = {}   # rid -> tick
        self._prefilling: Dict[int, int] = {}   # slot -> prompt rows written
        self._prefill_wait: Dict[int, int] = {} # slot -> ticks outranked
        self._slot_seq: Dict[int, int] = {}     # slot -> admission sequence
        self._admit_seq = 0
        self.chunk_steps = 0
        self.decode_steps = 0
        self.prefill_buckets: Dict[int, int] = {}  # bucket -> prefills run
        # Builds of each step, counted at its first use as the reference
        # counts its traces.
        self.decode_traces = 0
        self.prefill_traces: Dict[int, int] = {}
        self.verify_traces = 0
        # The decision counters below the class body (preemptions, holds,
        # spec and prefix counters, shed_by_class, preemption_log) are
        # views over the telemetry's aggregates.
        self.telemetry = telemetry_mod.Telemetry(
            enabled=serve_cfg.telemetry, capacity=serve_cfg.trace_capacity)
        # Overload accounting, as ``serve.traffic.summarize`` reads it.
        self.submit_tick: Dict[int, int] = {}   # rid -> tick of submit()
        self.finish_tick: Dict[int, int] = {}   # rid -> tick of last token
        self.rejected: Dict[int, str] = {}      # rid -> shed reason
        # rid -> done | forced:<reason> | rejected:<reason>
        self.outcome: Dict[int, str] = {}
        self._arrival_seq: Dict[int, int] = {}  # rid -> submit order
        self._n_arrivals = 0
        self._classes: Dict[str, SLOClass] = {
            c.name: c for c in (serve_cfg.classes or ())}
        if len(self._classes) != len(serve_cfg.classes or ()):
            raise ValueError("duplicate SLO class names")
        for c in self._classes.values():
            if c.rate is not None and c.rate <= 0:
                raise ValueError(f"class {c.name}: rate {c.rate} <= 0")
        self._buckets: Dict[str, float] = {
            c.name: c.bucket_cap for c in self._classes.values()
            if c.rate is not None}
        for name, lo in (("max_queue", 1), ("max_preemptions", 0),
                         ("prefill_chunks_per_tick", 1)):
            v = getattr(serve_cfg, name)
            if v is not None and v < lo:
                raise ValueError(f"{name} {v} < {lo}")
        if serve_cfg.preempt_cooldown < 0:
            raise ValueError(f"preempt_cooldown {serve_cfg.preempt_cooldown}"
                             f" < 0")
        self.degraded = False           # the load-shedding latch
        self.last_pressure = 0.0
        # Speculative decoding: verify steps (the (slot, tick) verifies,
        # drafts proposed and accepted and tokens emitted are views).
        if serve_cfg.spec_k < 0:
            raise ValueError(f"spec_k {serve_cfg.spec_k} < 0")
        self.spec_k = serve_cfg.spec_k
        # Under a mesh only the first rank of the pool's axis drafts; the
        # others take its drafts (``_agree_on_drafts``) and hold no draft.
        drafts_here = mesh is None or mesh.index(self._pool_axis) == 0
        self.draft = spec_mod.resolve_draft(serve_cfg.draft, cfg, params,
                                            self.device) \
            if self.spec_k and drafts_here else None
        self.verify_steps = 0
        # The adaptive width: drafts a slot asks for, and the window of
        # verify ticks (and their drafts proposed and accepted) it is
        # re-chosen from; plain ticks since the last trial tick.
        self.k_live = self.spec_k
        self._adapt_ticks = 0
        self._adapt_proposed = 0
        self._adapt_accepted = 0
        self._probe_wait = 0
        if serve_cfg.spec_adapt_every is not None and not (
                serve_cfg.spec_adapt_every >= 1 and self.spec_k):
            raise ValueError("spec_adapt_every needs spec_k > 0 and a "
                             "window of at least 1")
        if serve_cfg.spec_probe_every is not None and not (
                serve_cfg.spec_probe_every >= 1 and self.spec_k
                and serve_cfg.spec_adapt_every is not None):
            # Trial ticks re-open speculation through the adaptation
            # window, so probing needs it.
            raise ValueError("spec_probe_every needs spec_k > 0, "
                             "spec_adapt_every and a period of at least 1")
        # Prefix cache: each slot's publish chain (digest of its deepest
        # published page, pages published).
        self._chain: Dict[int, Tuple[bytes, int]] = {}
        self._pick = sampling.sampler(serve_cfg.temperature)
        self._base_key = sampling.prng_key(serve_cfg.seed)      # host copy
        self._rid_keys: Dict[int, torch.Tensor] = {}
        self._init_steps(capture)

    # -- telemetry-backed counter views ---------------------------------------

    admission_rejections = _counter_view(
        "admit_hold", "pool-exhausted admission holds")
    preemptions = _counter_view(
        "preempt", "slots evicted back to the queue")
    spec_ticks = _counter_view(
        "spec_verify", "(slot, tick) verify events")
    spec_proposed = _counter_view(
        "spec_proposed", "drafted tokens proposed")
    spec_accepted = _counter_view(
        "spec_accepted", "drafted tokens accepted")
    spec_emitted = _counter_view(
        "spec_emitted", "tokens emitted by verify ticks")
    downshifts = _counter_view(
        "degrade_enter", "clean -> degraded ladder transitions")
    degraded_ticks = _counter_view(
        "degraded_tick", "ticks spent in degraded mode")
    prefix_hits = _counter_view(
        "prefix_hit", "admissions that mapped cached prefix pages")
    prefix_misses = _counter_view(
        "prefix_miss", "admissions that probed the index and found none")
    prefix_hit_pages = _counter_view(
        "prefix_hit_pages", "cached pages mapped by admissions (sum)")
    cow_copies = _counter_view(
        "cow_copy", "copy-on-write splits of shared pages")
    prefix_evictions = _counter_view(
        "prefix_evict", "LRU reclaims of cached-idle prefix runs")
    spec_probes = _counter_view(
        "probe_tick", "one-draft trial ticks while speculation is off")

    @property
    def shed_by_class(self) -> Dict[str, int]:
        """Clean rejects a class (a view over ``shed`` events)."""
        return self.telemetry.shed_by_class

    @property
    def preemption_log(self) -> List[Tuple[int, str, int]]:
        """(rid, class, tokens generated at eviction) a ``preempt``
        event."""
        return self.telemetry.preemption_log

    # -- tensor parallelism ---------------------------------------------------

    def _check_mesh(self, cfg: ModelConfig, scfg: ServeConfig,
                    capture: bool) -> None:
        """What a tensor-parallel engine refuses, each with its reason."""
        if not scfg.paged:
            raise ValueError("mesh serving is paged-only (as the "
                             "reference's)")
        if self.device.type == "cuda" and capture:
            raise ValueError(
                "capture=True under a mesh: the collectives of a gloo "
                "group run through the host and cannot be captured in a "
                "CUDA graph; build the engine with capture=False")

    # -- device steps ---------------------------------------------------------

    @torch.no_grad()
    def _init_steps(self, capture: bool) -> None:
        """The static buffers each step reads and writes, and the steps
        over them: warmed up on the card (and captured) now, while every
        slot is empty, so that the warm-up's and the capture's writes land
        in the null page or in rows that admission overwrites; the caches
        are then zeroed, so a graphed engine and an eager one start warm
        from the same state."""
        dev, b = self.device, self.scfg.batch
        ints = dict(dtype=torch.int64, device=dev)
        # Decode: the last tokens, the (rid, emitted index) of each row's
        # key, the next ids; the write positions (and page table) are the
        # caches' own shared tensors.
        self._tok = torch.zeros((b,), **ints)
        self._rids = torch.zeros((b,), **ints)
        self._ts = torch.zeros((b,), **ints)
        self._next = torch.zeros((b,), **ints)
        self._dev_key = self._base_key.to(dev)
        t0 = time.perf_counter()
        steps: Dict[str, graphs.Step] = {}
        if self.spec_k:
            # Verify, in place of the decode step: each slot's pending
            # token and drafts, and the target's pick at each position.
            self._vtok = torch.zeros((b, self.spec_k + 1), **ints)
            self._picks = torch.zeros((b, self.spec_k + 1), **ints)
            self._verify = steps["verify"] = graphs.Step(self._verify_fn(),
                                                         dev, capture)
        if not self.spec_k or self.scfg.degrade \
                or self.scfg.spec_adapt_every is not None:
            # A speculative engine decodes only on its degraded ticks and
            # while its adaptive width is 0.
            self._decode = steps["decode"] = graphs.Step(self._decode_fn(),
                                                         dev, capture)
        if self.pool is not None:
            # Chunk: a batch-1 view of the pools through the slot's table
            # row, its tokens, write position, sampled row and key.
            self._ctok = torch.zeros((1, self.chunk), **ints)
            self._cstart = torch.zeros((1,), dtype=torch.int32, device=dev)
            self._cpages = torch.zeros((1, self.max_pages), dtype=torch.int32,
                                       device=dev)
            self._clast = torch.zeros((1,), **ints)
            self._ckey = torch.zeros((2,), **ints)
            self._cnext = torch.zeros((), **ints)
            self._chunk_caches = [dict(c, pages=self._cpages,
                                       index=self._cstart)
                                  for c in self.caches]
            self._chunk = steps["chunk"] = graphs.Step(self._chunk_fn(), dev,
                                                       capture)
        self.graphed = next(iter(steps.values())).graph is not None
        if dev.type == "cuda":
            for c in self.caches:
                for t in c.values():
                    t.zero_()
            torch.cuda.synchronize(dev)
        self.capture_seconds = time.perf_counter() - t0 if self.graphed \
            else 0.0
        # Device memory of each graph's private pool, and their sum.
        self.graph_pools = {name: s.graph_bytes for name, s in steps.items()
                            if s.graph is not None}
        self.graph_bytes = sum(self.graph_pools.values())
        # The port's kernels each captured graph holds, read back from it.
        self.graph_nodes = {name: s.nodes for name, s in steps.items()
                            if s.graph is not None}
        # The verify is attention over k + 1 rows a slot: the paged
        # prefill kernel once a layer, never a decode; the paged decode
        # step, the paged decode kernel once a layer.
        n = self.cfg.n_layers
        for name, want in (("verify", {"flash_attention_paged": n}),
                           ("decode", {"flash_decode_paged": n})):
            got = self.graph_nodes.get(name)
            if self.pool is not None and got is not None and got != want:
                raise RuntimeError(f"the {name} graph holds the kernels "
                                   f"{got}, not {want}")

    # The step functions close over the static buffers, not over the
    # engine: a captured step that held the engine would form a cycle, and
    # its caches would stay on the card until the garbage collector ran.

    def _decode_fn(self) -> Callable[[], None]:
        """The decode step over its static buffers: one token for every
        slot into ``_next``. Mamba's new conv and SSM state are copied
        into the caches in place, so that a replay reads them."""
        params, cfg, caches, pick = self.params, self.cfg, self.caches, \
            self._pick
        tok, rids, ts, out, base = (self._tok, self._rids, self._ts,
                                    self._next, self._dev_key)
        sampled = self.scfg.temperature > 0
        rules = self._ruleset

        def step() -> None:
            with sharding.use_ruleset(rules):
                logits, new = decode_step(params, cfg, tok, caches)
            for c, n in zip(caches, new):
                if "ssm" in c:
                    c["conv"].copy_(n["conv"])
                    c["ssm"].copy_(n["ssm"])
            keys = sampling.fold_row_keys(base, rids, ts) if sampled else None
            out.copy_(pick(logits, keys))

        return step

    def _verify_fn(self) -> Callable[[], None]:
        """The verify step over its static buffers: ``spec_k + 1`` rows a
        slot written through the table from its write position and
        attended (write-then-attend, the paged prefill kernel), the
        target's token at every position into ``_picks``; position j of
        row i drawn under the key of (rid i, t0 i + j)."""
        params, cfg, caches, pick = self.params, self.cfg, self.caches, \
            self._pick
        toks, rids, t0s, out, base = (self._vtok, self._rids, self._ts,
                                      self._picks, self._dev_key)
        width = self.spec_k + 1
        sampled = self.scfg.temperature > 0
        rules = self._ruleset

        def step() -> None:
            with sharding.use_ruleset(rules):
                logits, _ = T.forward(params, cfg, toks, caches=caches)
            keys = sampling.fold_span_keys(base, rids, t0s, width) \
                if sampled else None
            out.copy_(pick(logits, keys))

        return step

    def _chunk_fn(self) -> Callable[[], None]:
        """The chunk step over its static buffers: the chunk written in
        place through the slot's table row, the token at ``_clast``
        drawn under ``_ckey`` into ``_cnext``."""
        params, cfg, caches, pick = self.params, self.cfg, \
            self._chunk_caches, self._pick
        toks, last, key, out = self._ctok, self._clast, self._ckey, \
            self._cnext
        rules = self._ruleset

        def step() -> None:
            with sharding.use_ruleset(rules):
                logits, _ = T.forward(params, cfg, toks, caches=caches)
            out.copy_(pick(logits[0].index_select(0, last)[0], key))

        return step

    @torch.no_grad()
    def _chunk_step(self, tokens: np.ndarray, start: int, slot: int,
                    last_in_chunk: int, req: Request) -> torch.Tensor:
        """One ``chunk``-row slice of one slot's prompt, written in place
        through the slot's table row (a batch-1 view, write position
        ``start``). Returns the token at ``last_in_chunk``, drawn under
        ``req``'s next key, as a device scalar that the next chunk step
        overwrites: the host reads it only after the final chunk."""
        self._ctok.copy_(torch.from_numpy(tokens))
        self._cstart.fill_(start)
        self._clast.fill_(last_in_chunk)
        self._cpages.copy_(torch.from_numpy(self.pages[slot:slot + 1]))
        if self.scfg.temperature:
            self._ckey.copy_(self._emit_key(req))
        self._chunk()
        self.prefill_traces.setdefault(self.chunk, 1)
        self.chunk_steps += 1
        return self._cnext

    def _load_positions(self, active: List[int]) -> None:
        """Copy the write positions, the page table and (sampled) the
        active rows' key inputs into the static buffers a decode or
        verify step reads."""
        c0 = self.caches[0]
        c0["index"].copy_(torch.from_numpy(self.index))
        if self.pool is not None:
            c0["pages"].copy_(torch.from_numpy(self.pages))
        if self.scfg.temperature:
            rids, ts = self._rid_ts(active)
            self._rids.copy_(torch.from_numpy(rids))
            self._ts.copy_(torch.from_numpy(ts))

    @torch.no_grad()
    def _decode_step(self, active: List[int]) -> np.ndarray:
        """One token for every slot (free and mid-prefill slots ride
        along: their rows land in the null page, are overwritten, or are
        never attended)."""
        self._load_positions(active)
        self._tok.copy_(torch.from_numpy(self.last_tok))
        self._decode()
        self.decode_traces = 1
        self.decode_steps += 1
        self.index += 1
        return self._next.cpu().numpy().copy()

    @torch.no_grad()
    def _verify_step(self, tokens: np.ndarray, active: List[int]
                     ) -> np.ndarray:
        """Score ``tokens`` (batch, spec_k + 1) from every slot's write
        position; returns the picks (batch, spec_k + 1). Every write
        position advances by the width, as the step's own did."""
        self._load_positions(active)
        self._vtok.copy_(torch.from_numpy(tokens))
        self._verify()
        self.verify_traces = 1
        self.verify_steps += 1
        self.index += self.spec_k + 1
        return self._picks.cpu().numpy().copy()

    # -- sampling keys --------------------------------------------------------

    def _slot_key(self, rid: int, t: int) -> torch.Tensor:
        """Key of request ``rid``'s ``t``-th emitted token, on the host:
        keyed by (request, emitted index), never by tick, so a preempted
        and re-admitted stream replays its keys. A negative rid folds as
        its uint32 bit pattern, as on the device."""
        base = self._rid_keys.get(rid)
        if base is None:
            base = self._rid_keys[rid] = sampling.fold_in(self._base_key,
                                                          rid)
        return sampling.fold_in(base, t)

    def _emit_key(self, req: Request) -> torch.Tensor:
        """Key of the next token ``req`` emits."""
        return self._slot_key(req.rid, len(req.generated))

    def _rid_ts(self, active: List[int]):
        """(batch,) request ids and next emitted indices, the two int
        vectors the decode step folds into its rows' keys; 0 for a row
        that is not decode-active."""
        rids = np.zeros((self.scfg.batch,), np.int64)
        ts = np.zeros((self.scfg.batch,), np.int64)
        for i in active:
            rids[i] = self.slots[i].rid
            ts[i] = len(self.slots[i].generated)
        return rids, ts

    def bucket_for(self, prompt_len: int) -> int:
        """Prefill length of a prompt: the smallest power-of-two multiple
        of ``min_bucket`` that holds it, capped at ``max_len``, for
        attention stacks; the exact length for SSM stacks."""
        if not self._bucketed:
            return prompt_len
        b = self.scfg.min_bucket
        while b < prompt_len:
            b *= 2
        return min(b, self.scfg.max_len)

    @torch.no_grad()
    def _prefill_into_slot(self, prompt: np.ndarray, slot: int,
                           req: Request) -> int:
        """Prefill one prompt through a fresh batch-1 row cache at its
        bucket length, install the row in ``slot`` and return the token
        at the prompt's last position, drawn under ``req``'s next key. The
        padded rows past the prompt sit at positions >= its length, which
        the slot's write position masks out and decode overwrites."""
        true_len = len(prompt)
        bucket = self.bucket_for(true_len)
        if not true_len <= bucket <= self.scfg.max_len:
            raise ValueError(f"prompt of {true_len} rows does not fit "
                             f"max_len {self.scfg.max_len}")
        padded = np.zeros((1, bucket), np.int64)
        padded[0, :true_len] = prompt
        row = T.init_caches(self.cfg, 1, self.scfg.max_len,
                            per_slot_index=True, device=self.device)
        logits, row = T.forward(self.params, self.cfg,
                                torch.from_numpy(padded).to(self.device),
                                caches=row)
        self.prefill_buckets[bucket] = self.prefill_buckets.get(bucket, 0) + 1
        self.prefill_traces.setdefault(bucket, 1)
        for full, part in zip(self.caches, row):
            for name, t in full.items():
                if name != "index":
                    t[slot].copy_(part[name][0])
        self.index[slot] = true_len
        key = self._emit_key(req).to(self.device) \
            if self.scfg.temperature else None
        return int(self._pick(logits[0, true_len - 1], key))

    # -- page-table plumbing --------------------------------------------------

    def _append_pages(self, slot: int, pages: List[int],
                      fresh: bool = True) -> None:
        """Extend the slot's table with ``pages`` (entries [have, have +
        n); live entries are never overwritten). ``fresh=False``: a prefix
        hit maps pages that already exist, traced by ``prefix_hit``, so
        no ``page_alloc`` (whose sizes sum to the allocator's
        ``pages_allocated``)."""
        if not pages:
            return
        if fresh:
            self.telemetry.emit(self.ticks, "page_alloc", slot=slot,
                                n=len(pages))
        have = len(self.pool.slot_pages[slot]) - len(pages)
        self.pages[slot, have:have + len(pages)] = pages

    # -- prefix cache ---------------------------------------------------------

    def _cow_page(self, slot: int, pos: int) -> None:
        """Copy-on-write split of table position ``pos`` of ``slot``: a
        fresh page takes a copy of the shared page's rows in every layer
        (on the engine's stream, outside the graphs), and the host table
        names it; the next step reads the table."""
        old, new = self.pool.cow(slot, pos)
        self.telemetry.emit(self.ticks, "cow_copy", slot=slot, old=old,
                            new=new, pos=pos)
        if self.mesh is not None:
            serve_dist.copy_page(self.caches, old, new, self.mesh,
                                 self._pool_axis)
        else:
            for c in self.caches:
                c["kp"][new].copy_(c["kp"][old])
                c["vp"][new].copy_(c["vp"][old])
        self.pages[slot, pos] = new

    def _cow_range(self, slot: int, lo: int, hi: int) -> None:
        """Split every shared page that backs rows [lo, hi) of ``slot``
        before a write lands there: no write may touch a page with two
        holds or more."""
        if self.prefix is None:
            return
        held = self.pool.slot_pages.get(slot, ())
        ps = self.scfg.page_size
        for pos in range(lo // ps, min((max(hi, lo + 1) - 1) // ps,
                                       len(held) - 1) + 1):
            if self.pool.refcount(held[pos]) >= 2:
                self._cow_page(slot, pos)

    def _publish_rows(self, slot: int, req: Request, rows: int) -> None:
        """Publish every full page of the effective prompt below ``rows``
        (rows written) that ``slot``'s chain has not: such a page lies
        below every later write of the slot, so its rows stay as they
        are while the index holds it."""
        if self.prefix is None or slot not in self._chain:
            return
        ps = self.scfg.page_size
        digest, done = self._chain[slot]
        limit = min(int(rows), self._effective_len(req)) // ps
        if limit <= done:
            return
        prompt = self._effective_prompt(req)
        held = self.pool.slot_pages.get(slot, ())
        for j in range(done, min(limit, len(held))):
            nxt = self.prefix.publish(prompt[j * ps:(j + 1) * ps], held[j],
                                      digest, now=self.ticks)
            if nxt is None:            # a digest collision ends the chain
                break
            digest, done = nxt, j + 1
        self._chain[slot] = (digest, done)

    def _evict_prefixes(self, need: int, keep=()) -> bool:
        """Evict cached-idle prefix pages (LRU), never one in ``keep``,
        until ``need`` pages are free; True when they are. An idle entry
        costs a later prefill at most, so it goes before any hold or
        preemption."""
        if self.prefix is None:
            return self.pool.can_alloc(need)
        while not self.pool.can_alloc(need):
            n = self.prefix.evict(need - self.pool.free_pages,
                                  now=self.ticks, keep=keep)
            if not n:
                break
            self.telemetry.emit(self.ticks, "prefix_evict", n=n)
        return self.pool.can_alloc(need)

    # -- page accounting ------------------------------------------------------

    def _pages_through_tick(self, req: Request) -> int:
        """Table entries a decode-active slot needs for this tick's
        writes at positions prompt + generated - 1 up to ``spec_k`` rows
        past it (drafts backed before they are accepted; writes past
        max_len spill to the null page)."""
        length = len(req.prompt) + len(req.generated) - 1 + self.spec_k
        return min(length // self.scfg.page_size + 1, self.max_pages)

    def _ensure_decode_pages(self) -> None:
        """Split any shared page this tick's step writes into (a
        mid-prefill slot's ``1 + spec_k`` rows from its cursor, a
        decode-active slot's from its newest token on), then grow each
        decode-active slot's table so its writes land in real pages; a
        short pool preempts another slot, and a pool with nothing left to
        preempt raises ``PagePoolExhausted``, unless ``max_preemptions``
        is set: then the lone slot preempts itself (its partial stream
        re-queues, or finishes at the cap)."""
        for i, slot in enumerate(self.slots):
            if slot is None:
                continue
            if i in self._prefilling:
                cur = self._prefilling[i]
                self._cow_range(i, cur, cur + 1 + self.spec_k)
                continue
            eff = self._effective_len(slot)
            self._cow_range(i, max(0, eff - 1), eff + self.spec_k)
            target = self._pages_through_tick(slot)
            while len(self.pool.slot_pages.get(i, ())) < target:
                if not self._preempt_for(1, protect={i}):
                    if self.scfg.max_preemptions is not None:
                        self._preempt(i)
                        break
                    raise paged_mod.PagePoolExhausted(
                        f"slot {i} needs a decode page and no other slot "
                        f"is left to preempt; raise n_pages")
                self._append_pages(i, self.pool.alloc(i, 1))

    # -- preemption -----------------------------------------------------------

    def _class_priority(self, req: Request) -> int:
        cls = self._classes.get(req.rclass)
        return cls.priority if cls is not None else 0

    def _choose_victim(self, victims: List[int]) -> int:
        """The lowest class loses first; within a class the slot with the
        least completion progress, ties to the youngest admission. Two
        guards rank above that: a slot whose request reached
        ``max_preemptions`` ranks last of all (evicting it again would end
        it), and a slot re-admitted within ``preempt_cooldown`` ticks
        ranks behind its class peers. A sole victim is always taken."""
        lim = self.scfg.max_preemptions
        cool = self.scfg.preempt_cooldown

        def score(i):
            req = self.slots[i]
            ra = req.readmitted_at
            cooling = ra is not None and self.ticks - ra < cool
            capped = lim is not None and req.preempt_count >= lim
            done = len(req.generated) / max(1, req.max_new)
            return (capped, self._class_priority(req), cooling, done,
                    -self._slot_seq[i])

        return min(victims, key=score)

    def _preempt_for(self, need: int, protect: set) -> bool:
        """Evict cached-idle prefixes, then preempt slots outside
        ``protect``, until ``need`` pages are free. False when no victim
        is left."""
        if self._evict_prefixes(need):
            return True
        while not self.pool.can_alloc(need):
            victims = [i for i, s in enumerate(self.slots)
                       if s is not None and i not in protect]
            if not victims:
                return False
            self._preempt(self._choose_victim(victims))
        return True

    def _finish_forced(self, req: Request, reason: str) -> None:
        """Terminal: keep the partial stream (a prefix of the uncontended
        one: every token is keyed by (rid, index)) and leave."""
        req.done = True
        self.finished[req.rid] = req.generated
        self.finish_tick[req.rid] = self.ticks
        self.outcome[req.rid] = f"forced:{reason}"
        self.telemetry.emit(self.ticks, "finish", rid=req.rid,
                            rclass=req.rclass, outcome=f"forced:{reason}",
                            n_tokens=len(req.generated))

    def _reject(self, req: Request, reason: str) -> None:
        """Terminal: a clean reject of a request that emitted nothing,
        recorded by a ``shed`` event."""
        req.done = True
        self.rejected[req.rid] = reason
        self.outcome[req.rid] = f"rejected:{reason}"
        self.telemetry.emit(self.ticks, "shed", rid=req.rid,
                            rclass=req.rclass, reason=reason)

    def _preempt(self, i: int) -> None:
        """Evict slot ``i``: pages back to the pool, the request back to
        the head of the queue with its generated tokens. A context that
        already reaches max_len has nothing left to re-prefill: it
        finishes with what it generated. A request already evicted
        ``max_preemptions`` times finishes with its partial stream (or is
        rejected if it emitted nothing) instead."""
        req = self.slots[i]
        self.free_slot(i)
        self.last_tok[i] = 0
        if len(req.prompt) + len(req.generated) >= self.scfg.max_len:
            self._finish_forced(req, "max_len")
            return
        lim = self.scfg.max_preemptions
        if lim is not None and req.preempt_count >= lim:
            if req.generated:
                self._finish_forced(req, "preempt_limit")
            else:
                self._reject(req, "preempt_limit")
            return
        self.telemetry.emit(self.ticks, "preempt", rid=req.rid,
                            rclass=req.rclass,
                            n_generated=len(req.generated))
        req.preempt_count += 1
        self.queue.insert(0, req)

    # -- request lifecycle ----------------------------------------------------

    def submit(self, req: Request) -> None:
        self.submit_tick.setdefault(req.rid, self.ticks)
        self._arrival_seq.setdefault(req.rid, self._n_arrivals)
        self._n_arrivals += 1
        self.telemetry.emit(self.ticks, "submit", rid=req.rid,
                            rclass=req.rclass, prompt_rows=len(req.prompt),
                            max_new=req.max_new)
        self.queue.append(req)
        mq = self.scfg.max_queue
        if mq is None or len(self.queue) <= mq:
            return
        # Bounded queue: shed the lowest-priority newest fresh request
        # (never a preempted one: its tokens must reach an outcome). The
        # request just submitted is a candidate, so the bound holds.
        cands = [r for r in self.queue if not r.preempt_count]
        victim = min(cands, key=lambda r: (
            self._class_priority(r), -self._arrival_seq[r.rid]))
        self.queue.remove(victim)
        self._reject(victim, "queue_full")

    # -- SLO-aware admission --------------------------------------------------

    def _refill_buckets(self) -> None:
        """One tick's refill of every metered class, capped at its
        burst."""
        for name, cls in self._classes.items():
            if cls.rate is not None:
                self._buckets[name] = min(cls.bucket_cap,
                                          self._buckets[name] + cls.rate)

    def _bucket_ok(self, req: Request) -> bool:
        """Debit bucket: a class admits while its bucket is not negative;
        the admission's whole token cost then debits it (perhaps below
        zero). A re-admission was charged at its first and passes."""
        cls = self._classes.get(req.rclass)
        if cls is None or cls.rate is None or req.preempt_count:
            return True
        return self._buckets[req.rclass] >= 0.0

    def _charge_bucket(self, req: Request) -> None:
        cls = self._classes.get(req.rclass)
        if cls is None or cls.rate is None or req.preempt_count:
            return
        self._buckets[req.rclass] -= self._effective_len(req) + req.max_new

    def _admission_order(self) -> List[int]:
        """Queue indices in admission order: FIFO without classes; with
        them, preempted re-admissions first, then class priority
        descending, then arrival."""
        if not self._classes:
            return list(range(len(self.queue)))

        def key(qi):
            r = self.queue[qi]
            return (0 if r.preempt_count else 1, -self._class_priority(r),
                    self._arrival_seq.get(r.rid, qi), qi)

        return sorted(range(len(self.queue)), key=key)

    def _next_admission(self) -> Optional[int]:
        """The first queue index in admission order whose bucket admits;
        None when every queued request is throttled."""
        for qi in self._admission_order():
            if self._bucket_ok(self.queue[qi]):
                return qi
        return None

    @staticmethod
    def _effective_prompt(req: Request) -> np.ndarray:
        """Rows a (re-)admission prefills: prompt + tokens generated
        before a preemption."""
        prompt = np.asarray(req.prompt, np.int32)
        if req.generated:
            prompt = np.concatenate(
                [prompt, np.asarray(req.generated, np.int32)])
        return prompt

    @staticmethod
    def _effective_len(req: Request) -> int:
        return len(req.prompt) + len(req.generated)

    def _record(self, i: int, req: Request, tok: int) -> bool:
        """Append ``tok``; finish and free the slot on EOS or max_new."""
        req.generated.append(tok)
        if len(req.generated) == 1 and req.rid not in self.first_token_tick:
            self.first_token_tick[req.rid] = self.ticks
        if tok == self.scfg.eos_id or len(req.generated) >= req.max_new:
            req.done = True
            self.finished[req.rid] = req.generated
            self.finish_tick[req.rid] = self.ticks
            self.outcome[req.rid] = "done"
            self.telemetry.emit(self.ticks, "finish", rid=req.rid,
                                rclass=req.rclass, outcome="done",
                                n_tokens=len(req.generated))
            self.free_slot(i)
            return True
        return False

    def free_slot(self, i: int) -> None:
        """Release slot ``i``: its write position zeroed (decode stops
        reading the dead context) and, when paged, its holds on its pages
        dropped (those no one else holds go back to the pool) and its
        table row zeroed, so its drifting writes land in the null
        page."""
        self.slots[i] = None
        self._prefilling.pop(i, None)
        self._prefill_wait.pop(i, None)
        self._slot_seq.pop(i, None)
        self._chain.pop(i, None)
        self.index[i] = 0
        if self.pool is not None:
            # Refcounted: a page the index or another slot holds stays,
            # and ``page_free`` counts only the pages that freed.
            freed = self.pool.free_slot(i)
            if freed:
                self.telemetry.emit(self.ticks, "page_free", slot=i,
                                    n=len(freed))
            self.pages[i] = 0

    def _imminent_page_need(self) -> int:
        """Pages admitted slots take this tick: decode growth for
        decode-active slots, the next chunk for mid-prefill ones."""
        ps, max_len = self.scfg.page_size, self.scfg.max_len
        total = 0
        for i, slot in enumerate(self.slots):
            if slot is None:
                continue
            have = len(self.pool.slot_pages.get(i, ()))
            if i in self._prefilling:
                cursor = self._prefilling[i]
                total += paged_mod.chunk_page_need(
                    cursor, min(self.chunk, self._effective_len(slot) - cursor),
                    have, ps, max_len)
            else:
                total += max(0, self._pages_through_tick(slot) - have)
        return total

    def _admit(self) -> None:
        """Fill free slots from the queue in admission order. Paged: the
        first chunk's pages are reserved (the chunks run in
        ``_prefill_tick``), and a short pool holds the admission, which
        every later request waits behind. Contiguous: the whole prompt is
        prefilled and installed now."""
        self._refill_buckets()
        ps, max_len = self.scfg.page_size, self.scfg.max_len
        for i, slot in enumerate(self.slots):
            if slot is not None:
                continue
            while self.queue:
                qi = self._next_admission()
                if qi is None:
                    return            # every queued class throttled
                req = self.queue[qi]
                if self.pool is None:
                    self._admit_whole(i, qi, req)
                    break
                plen = self._effective_len(req)
                if plen > max_len:
                    raise ValueError(f"request {req.rid}: {plen} rows > "
                                     f"max_len {max_len}")
                # Whole prompt plus its first decode write (its drafts
                # included): a request that cannot fit the empty pool
                # could never finish. Under max_preemptions it gets an
                # outcome (forced, or rejected if it emitted nothing);
                # otherwise the engine raises.
                with_decode = paged_mod.pages_for(
                    min(plen + 1 + self.spec_k, max_len), ps)
                if with_decode > self.pool.capacity:
                    if self.scfg.max_preemptions is not None:
                        self.queue.pop(qi)
                        if req.generated:
                            self._finish_forced(req, "capacity")
                        else:
                            self._reject(req, "capacity")
                        continue       # this slot, the next request
                    raise paged_mod.PagePoolExhausted(
                        f"request {req.rid}: needs {with_decode} pages but "
                        f"the pool holds {self.pool.capacity}; raise n_pages "
                        f"or page_size")
                # The longest cached run of full pages. A prompt cached
                # whole still prefills its last row (the first token needs
                # its logit): the cursor stops at plen - 1, inside the
                # last hit page, which is split now, before any step
                # writes there.
                hit_pages: List[int] = []
                hit_digest, n_hit = paged_mod.ROOT_DIGEST, 0
                if self.prefix is not None:
                    hit_pages, hit_digest, n_hit = self.prefix.probe(
                        self._effective_prompt(req), plen // ps,
                        now=self.ticks)
                cursor = min(n_hit * ps, plen - 1)
                cow_at = n_hit - 1 if n_hit * ps > cursor else None
                # Priced: the first uncached chunk, the hit pages held
                # (and one page for the split).
                suffix_need = paged_mod.chunk_page_need(
                    cursor, min(self.chunk, plen - cursor), n_hit, ps,
                    max_len)
                first = suffix_need + (cow_at is not None)
                # The pages just probed are not evicted to make room for
                # the admission that maps them (the reference evicts
                # them, then fails its share() assertion).
                if not self._evict_prefixes(first + self._imminent_page_need(),
                                            keep=hit_pages):
                    self.telemetry.emit(self.ticks, "admit_hold", rid=req.rid,
                                        rclass=req.rclass, need=first,
                                        free=self.pool.free_pages)
                    return            # hold: everyone waits for pages
                self.queue.pop(qi)
                self._charge_bucket(req)
                self.slots[i] = req
                if req.preempt_count:
                    req.readmitted_at = self.ticks   # the storm guard
                self._prefilling[i] = cursor
                self._slot_seq[i] = self._admit_seq
                self._admit_seq += 1
                self.telemetry.emit(self.ticks, "admit", rid=req.rid, slot=i,
                                    rclass=req.rclass, rows=plen,
                                    readmit=req.preempt_count)
                if self.prefix is not None:
                    if n_hit:
                        self.pool.share(i, hit_pages)
                        self._append_pages(i, hit_pages, fresh=False)
                        self.telemetry.emit(self.ticks, "prefix_hit",
                                            rid=req.rid, slot=i,
                                            pages=n_hit, rows=cursor)
                        self.telemetry.count("prefix_hit_pages", n_hit)
                    else:
                        self.telemetry.emit(self.ticks, "prefix_miss",
                                            rid=req.rid, slot=i)
                    self._chain[i] = (hit_digest, n_hit)
                if cow_at is not None:
                    self._cow_page(i, cow_at)
                self._append_pages(i, self.pool.alloc(i, suffix_need))
                break

    def _admit_whole(self, i: int, qi: int, req: Request) -> None:
        """Contiguous admission of queue entry ``qi`` into free slot
        ``i``: its whole prompt prefilled and installed now and its first
        token recorded (a request that finishes on it leaves the slot
        free until the next tick)."""
        prompt = self._effective_prompt(req)
        self.queue.pop(qi)
        self._charge_bucket(req)
        self.telemetry.emit(self.ticks, "admit", rid=req.rid, slot=i,
                            rclass=req.rclass, rows=len(prompt),
                            readmit=req.preempt_count)
        bucket = self.bucket_for(len(prompt))
        with self.telemetry.span("prefill_bucket", self.ticks,
                                 slot=i) as sp:
            n0 = self.prefill_traces.get(bucket, 0)
            tok = self._prefill_into_slot(prompt, i, req)
            sp.compile = self.prefill_traces.get(bucket, 0) > n0
        self.slots[i] = req
        self._slot_seq[i] = self._admit_seq
        self._admit_seq += 1
        if not self._record(i, req, tok):
            self.last_tok[i] = tok

    def _prefill_order(self) -> List[int]:
        """Mid-prefill slots, fewest chunks left first, aged: each tick a
        slot was outranked under the chunk budget counts as one chunk
        less, so a long prompt is not starved by shorter arrivals
        (admission order breaks ties)."""
        def key(i):
            remaining = -(-(self._effective_len(self.slots[i])
                            - self._prefilling[i]) // self.chunk)
            return (remaining - self._prefill_wait.get(i, 0),
                    self._slot_seq[i])

        return sorted(self._prefilling, key=key)

    def _prefill_tick(self) -> None:
        """One chunk for each mid-prefill slot in ``_prefill_order``, up
        to the tick's budget (``prefill_chunks_per_tick``; 1 while
        degraded). Each chunk's pages are allocated right before it; a
        short pool preempts another slot or, with none left, stalls this
        slot for the tick."""
        ps, max_len = self.scfg.page_size, self.scfg.max_len
        budget = self.scfg.prefill_chunks_per_tick
        if self.degraded:
            budget = 1 if budget is None else min(1, budget)
        served = 0
        tel = self.telemetry
        for i in self._prefill_order():
            if budget is not None and served >= budget:
                # Outranked by a served chunk: age.
                if i in self._prefilling:
                    self._prefill_wait[i] = self._prefill_wait.get(i, 0) + 1
                continue
            if i not in self._prefilling:      # preempted by an earlier
                continue                       # slot's chunk this tick
            req = self.slots[i]
            cursor = self._prefilling[i]
            prompt = self._effective_prompt(req)
            true_len = len(prompt)
            n = min(self.chunk, true_len - cursor)
            need = paged_mod.chunk_page_need(
                cursor, n, len(self.pool.slot_pages.get(i, ())), ps, max_len)
            if need:
                if not self._preempt_for(need, protect={i}):
                    continue                   # stalled, retry next tick
                self._append_pages(i, self.pool.alloc(i, need))
            # The chunk step writes its whole padded width.
            self._cow_range(i, cursor, cursor + self.chunk)
            served += 1
            self._prefill_wait.pop(i, None)
            chunk_toks = np.zeros((1, self.chunk), np.int64)
            chunk_toks[0, :n] = prompt[cursor:cursor + n]
            end = cursor + n
            # A padded final chunk: the sampled row is the prompt's last
            # token, and the write position resets to `end` so the padded
            # rows are never attended.
            last_in = (true_len - 1 - cursor) if end == true_len else n - 1
            tel.emit(self.ticks, "prefill_chunk", rid=req.rid, slot=i,
                     start=cursor, rows=n)
            with tel.span("prefill_chunk", self.ticks, slot=i) as sp:
                n0 = self.prefill_traces.get(self.chunk, 0)
                tok = self._chunk_step(chunk_toks, cursor, i, last_in, req)
                sp.compile = self.prefill_traces.get(self.chunk, 0) > n0
            self.index[i] = end
            # Every row below `end` went through the chunk step: equal
            # token prefixes give equal pages, which later admissions map.
            self._publish_rows(i, req, end)
            if end < true_len:
                self._prefilling[i] = end
                continue
            del self._prefilling[i]            # prefill complete
            tok = int(tok)
            if not self._record(i, req, tok):
                self.last_tok[i] = tok

    def _update_pressure(self) -> None:
        """The load-shedding latch (``degrade``): the pressure signal
        (pool occupancy against queue depth, ``autotune.serve_pressure``)
        drives a hysteresis band (``choose_degradation``). Degraded ticks
        shed speculation and run one chunk; both downshifts emit exactly
        the tokens clean ticks would."""
        if not self.scfg.degrade:
            return
        occ = (self.pool.pages_in_use / max(1, self.pool.capacity)
               if self.pool is not None else
               sum(s is not None for s in self.slots) / self.scfg.batch)
        self.last_pressure = autotune.serve_pressure(
            occ, len(self.queue), self.scfg.batch)
        was = self.degraded
        self.degraded = autotune.choose_degradation(
            self.last_pressure, was, self.scfg.pressure_high,
            self.scfg.pressure_low)
        if self.degraded:
            # An aggregate only: the transitions are the ring's events.
            self.telemetry.count("degraded_tick")
            if not was:
                self.telemetry.emit(self.ticks, "degrade_enter",
                                    pressure=self.last_pressure)
        elif was:
            self.telemetry.emit(self.ticks, "degrade_exit",
                                pressure=self.last_pressure)

    def _spec_width(self) -> int:
        """Drafts a slot this tick: ``k_live``; 0 (a plain decode tick)
        without speculation or while degraded; and, while the adaptive
        width is 0 and ``spec_probe_every`` is set, 1 on every
        ``spec_probe_every``-th tick (a ``probe_tick``), whose accept
        counts feed the adaptation window like any verify tick's, so a
        recovered accept rate re-opens speculation."""
        if not self.spec_k or self.degraded:
            return 0
        if self.k_live:
            return self.k_live
        if self.scfg.spec_probe_every is None:
            return 0
        self._probe_wait += 1
        if self._probe_wait < self.scfg.spec_probe_every:
            return 0
        self._probe_wait = 0
        self.telemetry.emit(self.ticks, "probe_tick")
        return 1

    def _maybe_adapt_k(self) -> None:
        """Every ``spec_adapt_every`` verify ticks, re-choose ``k_live``
        from the window's accept rate (``spec.rechoose_k`` against the
        slots' context lengths, priced with the engine's constants). A
        collapsed rate prices speculation below plain decode and sets it
        to 0; only trial ticks (``spec_probe_every``) can then re-open it.
        The verify step keeps its ``spec_k + 1`` width either way."""
        every = self.scfg.spec_adapt_every
        if every is None:
            return
        self._adapt_ticks += 1
        if self._adapt_ticks < every:
            return
        rate = (self._adapt_accepted / self._adapt_proposed
                if self._adapt_proposed else 0.0)
        self.k_live, _ = spec_mod.rechoose_k(
            self.cfg, self.scfg.page_size,
            [max(1, n) for n in self.context_lengths()], rate, self.spec_k,
            constants=self.constants)
        self._adapt_ticks = 0
        self._adapt_proposed = 0
        self._adapt_accepted = 0

    def context_lengths(self) -> np.ndarray:
        """Each slot's write position, (batch,) int32: its live K/V rows
        (prompt and tokens so far) when decode-active, the rows it drifted
        through when free, the cursor when mid-prefill; the lengths the
        decode kernel reads. A host copy: no device read."""
        return self.index.astype(np.int32)

    def _decode_tick(self, active: List[int]) -> None:
        tel = self.telemetry
        # Context accounting from host ints (no device read).
        tel.count("decode_slot_ticks", len(active))
        tel.count("decode_context_rows",
                  sum(self._effective_len(self.slots[i]) for i in active))
        with tel.span("decode", self.ticks) as sp:
            n0 = self.decode_traces
            nxt = self._decode_step(active)
            sp.compile = self.decode_traces > n0
        active_set = set(active)
        for i in range(self.scfg.batch):
            if i in active_set:
                if not self._record(i, self.slots[i], int(nxt[i])):
                    continue
            # Freed or empty slot: feed back 0 so stale output never
            # aliases eos_id.
            nxt[i] = 0
        self.last_tok = nxt.astype(np.int64)

    def _draft_history(self, req: Request) -> np.ndarray:
        """What the draft source sees: the trailing ``window`` tokens of
        prompt + generated for a drafter that declares a window (its host
        work stays constant in the context), the whole history
        otherwise."""
        window = getattr(self.draft, "window", None)
        if window is None:
            return self._effective_prompt(req)
        gen = req.generated
        if len(gen) >= window:
            return np.asarray(gen[-window:], np.int32)
        head = req.prompt[max(0, len(req.prompt) - (window - len(gen))):]
        return np.concatenate([np.asarray(head, np.int32),
                               np.asarray(gen, np.int32)])

    def _spec_tick(self, active: List[int], k: int) -> None:
        """One draft-and-verify step: up to ``k`` drafts a decode-active
        slot (``k_live``, or 1 on a trial tick), scored with its pending
        token in the verify step of width ``spec_k + 1``; the longest
        accepted prefix and the target's next token are recorded (at least
        one token a slot, so a tick that accepts nothing is a plain decode
        tick), and the drafts proposed and accepted feed the adaptation
        window.

        The verify wrote ``spec_k + 1`` rows for every slot and advanced
        every write position by as many. The rows of the pending token and
        the accepted drafts are the rows plain decode would have written;
        a live slot's position goes back to its live length, so the
        rejected rows are overwritten by its next writes (or lie in the
        null page). Freed slots are at 0 (``free_slot``), mid-prefill
        slots go back to their cursors (``_reset_prefill_positions``)."""
        width = self.spec_k + 1
        tel = self.telemetry
        tel.count("verify_slot_ticks", len(active))
        tel.count("verify_context_rows",
                  sum(self._effective_len(self.slots[i]) for i in active))
        tokens = np.zeros((self.scfg.batch, width), np.int64)
        tokens[:, 0] = self.last_tok
        base_len: Dict[int, int] = {}
        n_prop: Dict[int, int] = {}
        with tel.span("draft", self.ticks):
            for i in active:
                req = self.slots[i]
                base_len[i] = self._effective_len(req) - 1  # write position
                if self.draft is None:         # a mesh rank that receives
                    n_prop[i] = 0
                    continue
                prop = np.asarray(self.draft.propose(
                    self._draft_history(req), k), np.int64).ravel()[:k]
                n_prop[i] = len(prop)
                tokens[i, 1:1 + len(prop)] = np.clip(prop, 0,
                                                     self.cfg.vocab - 1)
            if self.mesh is not None:
                self._agree_on_drafts(tokens, n_prop, active)
        with tel.span("spec_verify", self.ticks) as sp:
            n0 = self.verify_traces
            picks = self._verify_step(tokens, active)
            sp.compile = self.verify_traces > n0
        last = np.zeros((self.scfg.batch,), np.int64)
        for i in active:
            req = self.slots[i]
            # Only what was drafted is scored: a zero-padded position that
            # matched would inflate the accept count.
            accepted, emitted = spec_mod.longest_accept(
                tokens[i, 1:1 + n_prop[i]], picks[i, :n_prop[i] + 1])
            self._adapt_proposed += n_prop[i]
            self._adapt_accepted += accepted
            done, n_rec = False, 0
            for tok in emitted:
                n_rec += 1
                if self._record(i, req, tok):
                    done = True                # EOS or max_new: rest dropped
                    break
            # One event a (slot, tick), carrying the accept accounting.
            tel.emit(self.ticks, "spec_verify", rid=req.rid, slot=i,
                     proposed=n_prop[i], accepted=accepted, emitted=n_rec)
            if not done:
                # Live rows: the pending token and the n_rec - 1 accepted
                # drafts; the last emitted token is fed back unwritten.
                self.index[i] = base_len[i] + n_rec
                last[i] = emitted[n_rec - 1]
        self.last_tok = last

    def _agree_on_drafts(self, tokens: np.ndarray, n_prop: Dict[int, int],
                         active: List[int]) -> None:
        """Rank 0's drafts on every rank (``tokens`` and ``n_prop`` in
        place): one ``broadcast`` a verify tick of an int64 (slots,
        ``spec_k``) tensor, -1 past each slot's proposals. Every rank must
        verify the same drafts, or the ranks' collectives part ways; only
        rank 0 drafts, so no rank's proposals need to agree."""
        width = self.spec_k
        drafts = torch.full((self.scfg.batch, width), -1, dtype=torch.int64)
        for i in active:
            drafts[i, :n_prop[i]] = torch.from_numpy(
                tokens[i, 1:1 + n_prop[i]])
        got = serve_dist.broadcast(drafts, self.mesh,
                                   self._pool_axis).numpy()
        for i in active:
            n_prop[i] = int((got[i] >= 0).sum())
            tokens[i, 1:] = 0
            tokens[i, 1:1 + n_prop[i]] = got[i, :n_prop[i]]

    def _reset_prefill_positions(self) -> None:
        """The decode (verify) step advanced every slot's write position
        and wrote garbage rows from each mid-prefill slot's cursor (the
        next chunks overwrite them); put their positions back."""
        for i, cursor in self._prefilling.items():
            self.index[i] = cursor

    @torch.no_grad()
    def tick(self) -> int:
        """Update the degrade latch, admit, advance prefill chunks
        (paged), one decode step (or, with drafts this tick: ``spec_k``,
        not degraded and a live width, one draft-and-verify step) for the
        decode-active slots; returns
        the number of slots making progress. The tick and its phases run
        under wall-clock spans; none adds a synchronisation."""
        tel = self.telemetry
        t0 = tel.clock()
        self.ticks += 1
        self._update_pressure()
        with tel.span("admit", self.ticks):
            self._admit()
        with tel.span("prefill", self.ticks):
            if self.pool is not None:
                self._prefill_tick()
                self._ensure_decode_pages()
        active = [i for i, s in enumerate(self.slots)
                  if s is not None and i not in self._prefilling]
        if not active:
            tel.tick_done(self.ticks, t0)
            return len(self._prefilling)
        n = len(active) + len(self._prefilling)
        k = self._spec_width()
        if k:
            self._spec_tick(active, k)
            self._maybe_adapt_k()
        else:
            self._decode_tick(active)
        self._reset_prefill_positions()
        tel.tick_done(self.ticks, t0)
        return n

    def run_until_drained(self, max_ticks: int = 10000) -> Dict[int, List[int]]:
        for _ in range(max_ticks):
            if self.tick() == 0 and not self.queue:
                break
        return self.finished
