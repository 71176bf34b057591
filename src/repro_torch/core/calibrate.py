"""Calibration of the serving path's cost constants on the device (port of
``repro/core/calibrate.py``).

The paper's method is to find the constants a vendor does not publish by
probing: pointer-chase ladders for latency, streamed copies for bandwidth.
This module turns it on the serving path's own hand-set constants
(``core.autotune``), each measured on the device it runs on:

  dispatch_s        best-of-N round trip of a tiny kernel (launch and
                    synchronise): the floor every launch pays.
  page_lookup_s     the paged decode kernel (``flash_decode_paged``)
                    against the contiguous one (``flash_decode``) over a
                    sweep of context lengths at the served geometry
                    (qwen3-4b's 32 query and 8 kv heads of 80, pages of 16,
                    bf16), both regressed on the page-table entries the
                    sweep reads (``autotune.decode_launch``): the
                    difference of the slopes is the cost of an entry (the
                    pchase trick: vary one knob, read the marginal cost off
                    the line, subtract what the contiguous layout pays too).
                    On the card the times are device times.
  hbm_bandwidth     best-of-N ``a + 1`` over a buffer several times the
                    L2's size on the card (2 x its bytes a call: read and
                    write), the best rate over fp32 and bf16.
  chunk_dispatch_s  the mean ``prefill_chunk`` span of a small real paged
                    engine after a warm-up run (on the card the engine is
                    graphed, and the span is a graph replay's launch).
  draft_token_s     best-of-N ``NgramDraft.propose`` over a history where
                    every suffix has a continuation, a proposed token.
  prefix_hash_s     best-of-N chained page-digest walk and table probe, a
                    page.

Results persist in the tuning cache under ``calibrated:{backend}:{devices}:
{name}`` with their evidence (n_trials, spread, unit, timestamp);
``autotune.resolve_constants`` reads them back. Every probe takes the
device it measures; on the card a probe that cannot launch its kernel
fails, it never times the plain version instead.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import autotune, hwmodel
from repro_torch.kernels.flash_decode import SPLIT_ROWS

# The page-lookup probe's geometry: qwen3-4b's attention as served, in
# splits of the rows every decode ran before the tile chooser.
LOOKUP_HEADS, LOOKUP_KV_HEADS, LOOKUP_HEAD_DIM, LOOKUP_PAGE = 32, 8, 80, 16
LOOKUP_SPLIT = SPLIT_ROWS
# Context lengths it sweeps (rows a slot), and its slots.
LOOKUP_LENGTHS = (512, 1024, 2048, 4096, 8192)
LOOKUP_LENGTHS_FAST = (256, 512, 1024)
# A slope difference below this is noise: the constant is clamped to it
# (and the probe's detail says so), so that it stays priceable.
LOOKUP_FLOOR_S = 1e-10
# The card's stream: four times the L2 and more.
STREAM_BYTES_CUDA = 1 << 30
SPIN_CYCLES = 20_000_000          # about 11 ms at the SM's 1.755 GHz


@dataclasses.dataclass(frozen=True)
class ProbeResult:
    """One measured constant and the evidence behind it."""

    name: str
    value: float
    unit: str
    n_trials: int
    spread: float            # (max - min) / min over the trials
    detail: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        assert self.name in autotune.CALIBRATED_NAMES, self.name
        assert np.isfinite(self.value) and self.value > 0, \
            (self.name, self.value)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _best_of(fn: Callable[[], Any], n: int, device: torch.device,
             warmup: int = 2) -> Tuple[float, float, int]:
    """Best-of-N wall time of ``fn``, the device synchronised before and
    after each call (so the time holds the work, not just its launch):
    the minimum is the signal, (max - min) / min the spread the cache
    entry records."""
    for _ in range(warmup):
        fn()
    _sync(device)
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        _sync(device)
        times.append(time.perf_counter() - t0)
    best = min(times)
    spread = (max(times) - best) / best if best > 0 else 0.0
    return best, spread, n


def _device_s(fn: Callable[[int], Any], copies: int, iters: int) -> float:
    """Device seconds a call of ``fn(i)`` (cycling through ``copies``
    distinct inputs, so that the L2 does not hold one across calls):
    the calls are queued behind a spin of the card
    (``torch.cuda._sleep``) and timed between CUDA events, so they run
    back to back however long the host takes to launch each. The spin
    grows until the host has queued every call before it ends."""
    for i in range(3):
        fn(i % copies)
    torch.cuda.synchronize()
    cycles = SPIN_CYCLES
    while True:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(cycles)
        start.record()
        for i in range(iters):
            fn(i % copies)
        end.record()
        ahead = not start.query()         # the card still spinning
        torch.cuda.synchronize()
        if ahead or cycles >= 16 * SPIN_CYCLES:
            return start.elapsed_time(end) / iters / 1e3
        cycles *= 4


# -- probes -------------------------------------------------------------------


def probe_dispatch(device: torch.device, fast: bool = False) -> ProbeResult:
    """Launch floor: a kernel too small to compute anything measurable
    (``x + 1`` on 8 floats), launched and synchronised; its round trip
    is the launch's overhead."""
    x = torch.zeros((8,), dtype=torch.float32, device=device)
    n = 10 if fast else 30
    best, spread, n = _best_of(lambda: x + 1.0, n, device)
    return ProbeResult("dispatch_s", best, "s/dispatch", n, spread,
                       {"probe": "tiny_kernel_best_of_n",
                        "device": device.type})


def _lookup_inputs(gen, device, batch: int, length: int, copies: int):
    """``copies`` sets of decode inputs at one context length: q, a page
    pool walked through a shuffled table, and the same rows laid out
    contiguously."""
    h, kvh, d, ps = (LOOKUP_HEADS, LOOKUP_KV_HEADS, LOOKUP_HEAD_DIM,
                     LOOKUP_PAGE)
    dtype = torch.bfloat16
    max_pages = length // ps
    n_pages = batch * max_pages + 1                # page 0: the null page
    out = []
    for _ in range(copies):
        q = torch.randn((batch, h, d), generator=gen, device=device).to(dtype)
        kp = torch.randn((n_pages, ps, kvh, d), generator=gen,
                         device=device).to(dtype)
        vp = torch.randn((n_pages, ps, kvh, d), generator=gen,
                         device=device).to(dtype)
        perm = torch.randperm(n_pages - 1, generator=gen, device=device)
        table = (perm + 1).to(torch.int32).reshape(batch, max_pages)
        flat = table.reshape(-1).long()
        kc = kp[flat].reshape(batch, length, kvh, d).contiguous()
        vc = vp[flat].reshape(batch, length, kvh, d).contiguous()
        lengths = torch.full((batch,), length, dtype=torch.int32,
                             device=device)
        out.append((q, kp, vp, table, kc, vc, lengths))
    return out


def probe_page_lookup(device: torch.device,
                      fast: bool = False) -> ProbeResult:
    """Page-walk slope: ``flash_decode_paged`` against the contiguous
    ``flash_decode`` over a sweep of context lengths at the served
    geometry, each regressed on the page-table entries its launches read;
    the difference of the two slopes is the cost of an entry. On the card
    the times are device times, and both kernels must have launched."""
    from repro_torch.kernels import ops

    lengths = LOOKUP_LENGTHS_FAST if fast else LOOKUP_LENGTHS
    batch = 2 if fast else 8
    n = 3 if fast else 7
    iters = 20
    gen = torch.Generator(device=device).manual_seed(0)
    cuda = device.type == "cuda"
    launched0 = dict(ops.LAUNCHES)
    visited, t_paged, t_contig = [], [], []
    for length in lengths:
        # On the card, enough copies of the inputs that together they
        # exceed the L2 several times over.
        call_bytes = 2 * batch * length * LOOKUP_KV_HEADS \
            * LOOKUP_HEAD_DIM * 2
        copies = max(2, -(-4 * hwmodel.H100.l2_bytes // call_bytes)) \
            if cuda else 1
        sets = _lookup_inputs(gen, device, batch, length, copies)

        # The tile is pinned (``LOOKUP_SPLIT``): the chooser's pick moves
        # with the sweep's lengths, and the slope would move with it.
        def paged(i):
            q, kp, vp, table, _, _, lens = sets[i]
            return ops.flash_decode_paged(q, kp, vp, table, lens,
                                          block_k=LOOKUP_SPLIT)

        def contig(i):
            q, _, _, _, kc, vc, lens = sets[i]
            return ops.flash_decode(q, kc, vc, lens, block_k=LOOKUP_SPLIT)

        if cuda:
            tp = min(_device_s(paged, copies, iters) for _ in range(n))
            tc = min(_device_s(contig, copies, iters) for _ in range(n))
        else:
            tp, _, _ = _best_of(lambda: paged(0), n, device)
            tc, _, _ = _best_of(lambda: contig(0), n, device)
        visited.append(autotune.decode_launch(
            [length] * batch, LOOKUP_HEADS, LOOKUP_KV_HEADS,
            LOOKUP_HEAD_DIM, LOOKUP_PAGE, 2)["page_lookups"])
        t_paged.append(tp)
        t_contig.append(tc)
        del sets
    launches = {k: ops.LAUNCHES[k] - launched0[k]
                for k in ("flash_decode_paged", "flash_decode")}
    if cuda and min(launches.values()) <= 0:
        raise RuntimeError(f"page-lookup probe: a decode kernel did not "
                           f"launch: {launches}")
    slope_paged = float(np.polyfit(visited, t_paged, 1)[0])
    slope_contig = float(np.polyfit(visited, t_contig, 1)[0])
    diff = slope_paged - slope_contig
    value = max(diff, LOOKUP_FLOOR_S)
    spread = (max(t_paged) - min(t_paged)) / max(min(t_paged), 1e-12)
    return ProbeResult(
        "page_lookup_s", value, "s/lookup", n * len(lengths), spread,
        {"probe": "table_sweep_slope", "tables": list(lengths),
         "batch": batch, "page_size": LOOKUP_PAGE,
         "split_rows": LOOKUP_SPLIT,
         "heads": (LOOKUP_HEADS, LOOKUP_KV_HEADS, LOOKUP_HEAD_DIM),
         "lookups": visited, "t_paged_s": t_paged, "t_contig_s": t_contig,
         "slope_paged_s": slope_paged, "slope_contig_s": slope_contig,
         "slope_difference_s": diff, "clamped": diff < LOOKUP_FLOOR_S,
         "timing": "device" if cuda else "wall", "launches": launches})


def probe_hbm_stream(device: torch.device,
                     fast: bool = False) -> ProbeResult:
    """Device stream rate: ``a + 1`` moves 2 x nbytes (read and write);
    the best rate over fp32 and bf16 is what the models price weight and
    K/V streams with. On the card the buffer is several times the L2, so
    the stream reads the memory; a rate above the data sheet's would be
    a cache's, and fails the probe."""
    cuda = device.type == "cuda"
    n = 5 if fast else 15
    rates, elems = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        size = dtype.itemsize
        count = STREAM_BYTES_CUDA // size if cuda else \
            ((1 << 18) if fast else (1 << 21))
        a = torch.ones((count,), dtype=dtype, device=device)
        best, _, _ = _best_of(lambda: a + 1, n, device)
        rates[str(dtype).replace("torch.", "")] = 2.0 * count * size / best
        elems[str(dtype).replace("torch.", "")] = count
        del a
    value = max(rates.values())
    if cuda and value > hwmodel.H100.hbm_bandwidth:
        raise RuntimeError(
            f"stream rate {value:.4e} B/s is above the data sheet's "
            f"{hwmodel.H100.hbm_bandwidth:.4e}: the stream read a cache")
    spread = (max(rates.values()) - min(rates.values())) \
        / max(min(rates.values()), 1e-12)
    return ProbeResult(
        "hbm_bandwidth", value, "bytes/s", n * len(rates), spread,
        {"probe": "stream_copy", "rates_by_dtype": rates, "elems": elems,
         "bytes_over_l2": (STREAM_BYTES_CUDA / hwmodel.H100.l2_bytes
                           if cuda else None),
         "share_of_data_sheet": value / hwmodel.H100.hbm_bandwidth})


def probe_chunk_dispatch(device: torch.device,
                         fast: bool = False) -> ProbeResult:
    """Steady-state chunk step cost from a small real paged engine (the
    smoke qwen3-4b at the served head_dim of 80, which the kernels take):
    one drained run to warm it, the telemetry reset, then the measured
    runs; the mean ``prefill_chunk`` span is what the chunk model's
    dispatch term prices. On the card the engine is graphed, and a chunk
    span holds the replay's launch, not its device time."""
    from repro_torch import configs
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import Request, ServeConfig, ServingEngine

    cfg = dataclasses.replace(configs.get_smoke("qwen3-4b"), head_dim=80)
    gen = torch.Generator(device=device).manual_seed(0)
    params = T.init_params(cfg, gen, device=device)
    eng = ServingEngine(params, cfg, ServeConfig(
        max_len=32, batch=2, eos_id=-1, paged=True, page_size=8,
        chunk_size=8), device=device)
    rng = np.random.default_rng(0)

    def drain(rid0: int):
        for i in range(2):
            prompt = rng.integers(0, 64, size=24).astype(np.int32)
            eng.submit(Request(rid=rid0 + i, prompt=prompt, max_new=2))
        eng.run_until_drained()

    drain(0)                       # warm: every step built
    eng.telemetry.reset()
    for r in range(1 if fast else 4):
        drain(100 + 10 * r)
    st = eng.telemetry.span_stats()["prefill_chunk"]
    assert st["execute_n"] > 0, st
    return ProbeResult(
        "chunk_dispatch_s", st["execute_mean_s"], "s/chunk",
        int(st["execute_n"]),
        (st["max_s"] - st["execute_mean_s"]) / max(st["execute_mean_s"],
                                                   1e-12),
        {"probe": "engine_chunk_span", "chunk": eng.chunk,
         "graphed": eng.graphed,
         "span": ("a graph replay's launch: the chunk span reads nothing "
                  "back from the device" if eng.graphed
                  else "an eager chunk step")})


def probe_draft_token(device: torch.device,
                      fast: bool = False) -> ProbeResult:
    """Host n-gram draft cost a proposed token, over a motif-rich history
    (every suffix has a continuation, so the scan pays its full lookup).
    Host only: ``device`` is not read."""
    from repro_torch.serve.spec import NgramDraft

    draft = NgramDraft()
    history = np.tile(np.arange(16, dtype=np.int32), 64)
    k = 4
    n = 10 if fast else 30
    best, spread, n = _best_of(lambda: draft.propose(history, k), n,
                               torch.device("cpu"))
    return ProbeResult(
        "draft_token_s", max(best / k, 1e-12), "s/token", n, spread,
        {"probe": "ngram_propose", "k": k, "history": len(history)})


def probe_prefix_hash(device: torch.device,
                      fast: bool = False) -> ProbeResult:
    """Prefix-cache recognition cost a page: the chained page digest (the
    page's tokens hashed into the parent digest) and the probe of the
    digest table that admission pays for each prompt page. Host only."""
    from repro_torch.serve import paged

    n_pages = 16 if fast else 64
    page_size = 8
    rng = np.random.default_rng(0)
    chunks = [paged.token_bytes(
        rng.integers(0, 1 << 15, size=page_size).astype(np.int32))
        for _ in range(n_pages)]
    table: Dict[bytes, int] = {}

    def walk():
        parent = paged.ROOT_DIGEST
        for chunk in chunks:
            parent = paged._page_digest(parent, chunk)
            table.get(parent)
        return parent

    n = 5 if fast else 15
    best, spread, n = _best_of(walk, n, torch.device("cpu"))
    return ProbeResult(
        "prefix_hash_s", max(best / n_pages, 1e-12), "s/page", n, spread,
        {"probe": "digest_chain", "pages": n_pages})


# -- the pass -----------------------------------------------------------------

PROBES: Dict[str, Callable[[torch.device, bool], ProbeResult]] = {
    "dispatch_s": probe_dispatch,
    "page_lookup_s": probe_page_lookup,
    "hbm_bandwidth": probe_hbm_stream,
    "chunk_dispatch_s": probe_chunk_dispatch,
    "draft_token_s": probe_draft_token,
    "prefix_hash_s": probe_prefix_hash,
}
assert tuple(PROBES) == autotune.CALIBRATED_NAMES


def run_calibration(fast: bool = False, persist: bool = True,
                    device=None, mesh_shape=None,
                    backend: Optional[str] = None
                    ) -> Dict[str, ProbeResult]:
    """Run every probe on ``device`` (the card unless the caller asks for
    the CPU); with ``persist``, write each result into the tuning cache's
    ``calibrated:`` namespace under the device's type (or ``backend``),
    so that ``resolve_constants`` prefers it from the next engine on."""
    device = resolve_device(device)
    backend = backend or device.type
    results: Dict[str, ProbeResult] = {}
    for name, probe in PROBES.items():
        res = probe(device, fast)
        results[name] = res
        if persist:
            autotune.record_calibration(
                name, res.value, mesh_shape=mesh_shape, backend=backend,
                n_trials=res.n_trials, spread=res.spread, unit=res.unit,
                timestamp=time.time(), fast=bool(fast))
    return results
