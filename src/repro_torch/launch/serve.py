"""Serving launcher: a batch of requests through the serving engine,
contiguous caches by default, a page pool with ``--paged``.

  python -m repro_torch.launch.serve --arch qwen3-4b --requests 8
  python -m repro_torch.launch.serve --arch mamba2-370m --requests 8
  python -m repro_torch.launch.serve --arch qwen3-4b --paged --smoke \\
      --device cpu --max-len 64 --page-size 8 --chunk-size 8 --max-new 6
  python -m repro_torch.launch.serve --arch qwen3-4b --temperature 0.8
  python -m repro_torch.launch.serve --arch qwen3-4b --paged --spec-k 4 \
      --prefix-cache
  python -m repro_torch.launch.serve --arch qwen3-4b --paged --spec-k 4 \
      --spec-probe-every 4 --pool-frac 0.5

Open-loop traffic (``--rate``) replaces the batch submit with the seeded
arrival generator (``serve/traffic.py``), SLO-aware admission and the
operator report; ``--faults`` adds the canonical fault schedule:

  python -m repro_torch.launch.serve --arch qwen3-4b --paged --smoke \
      --device cpu --max-len 64 --page-size 8 --chunk-size 8 --requests 24 \
      --rate 2.0 --process bursty --max-queue 8 --max-preemptions 3 \
      --degrade --faults --tenant "name=paid,priority=2,weight=1" \
      --tenant "name=free,weight=3,rate=2,burst=16,ttft=32" \
      --trace-out trace.json

The chunk size (``--chunk-size`` unset) and the adaptive draft width are
priced by the serving cost models with the constants
``python -m repro_torch.launch.calibrate`` measured on this device type,
or with the hand-set defaults (``--default-constants``, or nothing
measured); the report's ``constants:`` line says which.

Weights are random, drawn on the device from a ``torch.Generator`` seeded
with ``--seed``, which also seeds the sampling keys at ``--temperature``
above 0 and the traffic. Cached attention and the SSD scan run through
the port's kernels (their plain versions on the CPU). On a card each
decode (or, with ``--spec-k``, verify; both with ``--degrade``) and chunk
step is one captured CUDA graph. An encoder-decoder or a config with a
stubbed frontend (whisper-medium, llama-3.2-vision-90b) is refused, as
the reference's launcher refuses it: ``serve.engine.greedy_generate``
serves those with their frontend's embeddings.

``--tp N`` (or ``--mesh model=N``; paged only) serves tensor-parallel over
N ranks of a gloo process group (``serve.dist``): the launcher spawns one
process a rank (``launch.mesh.run_ranks``), or, where ``RANK`` and
``WORLD_SIZE`` are set (with ``MASTER_ADDR``/``MASTER_PORT``), joins that
group as its rank. Every rank draws the same weights and keeps its
shard; rank 0 prints the report. A rank that fails ends every rank, and
the launcher exits non-zero. On a card two ranks may share it (gloo
allows it; NCCL does not) and the engine runs eager, since gloo's
collectives cannot be captured in a CUDA graph:

  python -m repro_torch.launch.serve --arch qwen3-4b --paged --tp 2 \
      --max-len 512 --requests 4 --max-new 16
  python -m repro_torch.launch.serve --arch qwen3-4b --paged --smoke \
      --device cpu --max-len 64 --page-size 8 --chunk-size 8 --tp 2

A mixture of experts (dbrx-132b, llama4-maverick) serves with its experts
split over the ranks, and ``--spec-k`` takes any draft under ``--tp``
(rank 0's drafts are broadcast to every rank):

  python -m repro_torch.launch.serve --arch dbrx-132b --smoke --paged \
      --device cpu --max-len 64 --page-size 8 --chunk-size 8 --tp 2
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import time

import numpy as np
import torch

from repro_torch import configs, resolve_device
from repro_torch.core import autotune
from repro_torch.kernels import ops
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import transformer as T
from repro_torch.serve import traffic
from repro_torch.serve.engine import (Request, ServeConfig, ServingEngine,
                                      SLOClass)
from repro_torch.serve.faults import FaultInjector, canonical_schedule


def _parse_tenant(spec: str):
    """``name=paid,priority=2,rate=1.5,burst=8,ttft=16,tpot=4,weight=1``
    -> (SLOClass, TrafficClass), unset fields at their defaults."""
    kv = {}
    for part in spec.split(","):
        k, sep, v = part.partition("=")
        if not sep or not k:
            raise SystemExit(f"--tenant wants k=v pairs, got {part!r}")
        kv[k.strip()] = v.strip()
    name = kv.pop("name", None)
    if not name:
        raise SystemExit(f"--tenant needs name=..., got {spec!r}")
    known = {"priority", "ttft", "tpot", "rate", "burst", "weight",
             "prompt-lo", "prompt-hi", "out-lo", "out-hi", "ttft-ms",
             "tpot-ms", "sessions", "prefix-len"}
    if set(kv) - known:
        raise SystemExit(f"--tenant unknown keys {sorted(set(kv) - known)}")
    num = lambda k, d=None: float(kv[k]) if k in kv else d  # noqa: E731
    slo = SLOClass(name, priority=int(num("priority", 0)),
                   ttft_slo=num("ttft"), tpot_slo=num("tpot"),
                   rate=num("rate"), burst=num("burst"))
    tcls = traffic.TrafficClass(
        name, weight=num("weight", 1.0),
        prompt_lo=int(num("prompt-lo", 4)),
        prompt_hi=int(num("prompt-hi", 12)),
        out_lo=int(num("out-lo", 2)), out_hi=int(num("out-hi", 8)),
        ttft_ms=num("ttft-ms"), tpot_ms=num("tpot-ms"),
        sessions=int(num("sessions", 0)),
        prefix_len=int(num("prefix-len", 0)))
    return slo, tcls


def _report(engine, arrivals, res, inj, dt, tcfg, process, rate) -> None:
    """The operator's report of an open-loop run (``traffic.summarize``)."""
    s = traffic.summarize(engine, arrivals, classes=tcfg.classes)
    print(f"offered {s['offered']} requests at rate {rate} ({process}): "
          f"{s['done']} done, {s['forced']} forced, {s['rejected']} "
          f"rejected, {len(res['unresolved'])} unresolved in {s['ticks']} "
          f"ticks / {dt:.2f}s")
    print(f"  ttft p50/p99 {s['ttft_p50']:.0f}/{s['ttft_p99']:.0f} ticks, "
          f"tpot p50/p99 {s['tpot_p50']:.2f}/{s['tpot_p99']:.2f}, goodput "
          f"{s['goodput_tokens_per_tick']:.2f} tok/tick, shed "
          f"{s['shed_rate']:.2f}")
    print(f"  preemptions {s['preemptions']}, admission holds "
          f"{s['admission_holds']}, downshifts {s['downshifts']} "
          f"({s['degraded_ticks']} degraded ticks), spec probes "
          f"{engine.spec_probes}")
    if "tick_wall_s_mean" in s:
        print(f"  wall-clock: tick mean/p99 {s['tick_wall_s_mean'] * 1e3:.2f}"
              f"/{s['tick_wall_s_p99'] * 1e3:.2f} ms, ttft p50 "
              f"{s['ttft_ms_p50']:.0f} ms, tpot p50 {s['tpot_ms_p50']:.1f} "
              f"ms/token")
    if "ttft_wall_ms_p50" in s:
        print(f"  stamps: ttft p50/p95/p99 {s['ttft_wall_ms_p50']:.1f}/"
              f"{s['ttft_wall_ms_p95']:.1f}/{s['ttft_wall_ms_p99']:.1f} ms, "
              f"queue wait p50/p95/p99 {s['queue_wait_ms_p50']:.1f}/"
              f"{s['queue_wait_ms_p95']:.1f}/{s['queue_wait_ms_p99']:.1f} ms")
    if "prefill_wait_ms_p50" in s:
        print(f"  prefill wait p50/p95/p99 {s['prefill_wait_ms_p50']:.1f}/"
              f"{s['prefill_wait_ms_p95']:.1f}/"
              f"{s['prefill_wait_ms_p99']:.1f} ms")
    if inj is not None:
        print(f"  faults: {inj.injected} injected, {inj.cleared} cleared, "
              f"{engine.pool.pages_in_use if engine.pool else 0} pages "
              f"leaked")
    for name, c in sorted(s["by_class"].items()):
        slo = (f", ttft-slo {c['ttft_slo_attainment']:.0%}"
               if "ttft_slo_attainment" in c else "")
        slo += (f", ttft-ms-slo {c['ttft_ms_slo_attainment']:.0%}"
                if "ttft_ms_slo_attainment" in c else "")
        print(f"  class {name}: {c['done']}/{c['offered']} done, shed "
              f"{engine.shed_by_class.get(name, 0)}{slo}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-4b", type=configs.canonical_id,
                    choices=list(configs.ALIASES),
                    help="a CLI id or its module's name "
                         "(configs.list_archs())")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--paged", action="store_true",
                    help="K/V rows from a shared page pool (attention "
                         "stacks only); default: contiguous caches")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--chunk-size", type=int, default=None,
                    help="prefill chunk rows (paged; page-size multiple); "
                         "default: the chunk cost model's choice")
    ap.add_argument("--pool-frac", type=float, default=1.0,
                    help="page pool as a fraction of the contiguous "
                         "batch * max_len reservation (paged; >= 1.0 keeps "
                         "the full, exhaustion-free pool)")
    ap.add_argument("--prefix-cache", default=False,
                    action=argparse.BooleanOptionalAction,
                    help="share full-page prompt prefixes across requests "
                         "through the page table (paged only; refcounted "
                         "pages, copy-on-write)")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="speculative decoding: drafted tokens a verify "
                         "tick (paged only; 0 disables)")
    ap.add_argument("--draft", default="ngram",
                    help="draft source for --spec-k: 'ngram' (prompt "
                         "lookup), 'self' (sliding-window self-speculation) "
                         "or an arch name")
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0: greedy; above 0, sampled under threefry keys "
                         "of (request, emitted index)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    traf = ap.add_argument_group(
        "open-loop traffic / SLO admission",
        "--rate switches from the batch submit to the seeded open-loop "
        "generator (serve/traffic.py): requests arrive on a Poisson or "
        "bursty clock, admission is SLO-aware, and the run ends with the "
        "operator report.")
    traf.add_argument("--rate", type=float, default=None,
                      help="offered load in requests an engine tick "
                           "(enables traffic mode)")
    traf.add_argument("--process", choices=("poisson", "bursty"),
                      default="poisson", help="arrival process")
    traf.add_argument("--burst-factor", type=float, default=8.0,
                      help="burst-state rate multiplier (bursty)")
    traf.add_argument("--tenant", action="append", default=[],
                      help="repeatable tenant class: 'name=paid,priority=2,"
                           "rate=1.5,burst=8,ttft=16,tpot=4,weight=1,"
                           "prompt-lo=4,prompt-hi=12,out-lo=2,out-hi=8'; "
                           "ttft-ms/tpot-ms score wall-clock targets")
    traf.add_argument("--max-queue", type=int, default=None,
                      help="bounded queue: overflow sheds the "
                           "lowest-priority newest request")
    traf.add_argument("--max-preemptions", type=int, default=None,
                      help="a request preempted this many times is "
                           "force-finished or rejected instead")
    traf.add_argument("--degrade", action="store_true",
                      help="downshift under pressure (spec off, prefill "
                           "budget 1); recovers on its own")
    traf.add_argument("--spec-probe-every", type=int, default=None,
                      help="re-choose the draft width from the accept "
                           "rate every this many verify ticks and, once "
                           "it reaches 0, run a one-draft trial tick this "
                           "often so speculation can re-open (needs "
                           "--spec-k)")
    traf.add_argument("--faults", action="store_true",
                      help="run the canonical fault schedule (pool squeeze "
                           "-> accept collapse -> churn storm)")
    obs = ap.add_argument_group(
        "observability (serve/telemetry.py)",
        "Event traces and wall-clock spans are on by default.")
    obs.add_argument("--trace-out", default=None, metavar="PATH",
                     help="write the Chrome-trace/Perfetto JSON timeline "
                          "here after the run")
    obs.add_argument("--no-telemetry", action="store_true",
                     help="no event ring and no spans (the decision "
                          "counters stay exact)")
    ap.add_argument("--tp", type=int, default=None,
                    help="serve tensor-parallel over this many ranks "
                         "(paged only: weights split, the K/V page pool "
                         "sharded by pages); 1 serves on one rank")
    ap.add_argument("--mesh", default=None,
                    help="the serving mesh as model=N, another spelling "
                         "of --tp")
    obs.add_argument("--default-constants", action="store_true",
                     help="price choose_* decisions with the hand-set "
                          "default constants, skipping any calibrated "
                          "entry (see repro_torch.launch.calibrate)")
    args = ap.parse_args(argv)
    if args.default_constants:
        os.environ[autotune.DEFAULT_CONSTANTS_ENV] = "1"
    if args.rate is None and (args.tenant or args.faults):
        raise SystemExit("--tenant/--faults need --rate (traffic mode)")
    if args.trace_out and args.no_telemetry:
        raise SystemExit("--trace-out needs telemetry (drop --no-telemetry)")
    if args.spec_k and not args.paged:
        raise SystemExit("--spec-k needs --paged (the verify runs the paged "
                         "prefill kernel)")
    if args.prefix_cache and not args.paged:
        raise SystemExit("--prefix-cache needs --paged (sharing happens "
                         "through the page table)")
    if args.spec_probe_every is not None and not args.spec_k:
        raise SystemExit("--spec-probe-every needs --spec-k")
    if args.tp is not None and args.mesh is not None:
        raise SystemExit("--tp and --mesh are two spellings of one choice; "
                         "pass one")
    tp = args.tp
    if args.mesh is not None:
        axis, _, size = args.mesh.partition("=")
        if axis != "model" or not size.isdigit():
            raise SystemExit(f"--mesh wants model=N, got {args.mesh!r}")
        tp = int(size)
    if tp is not None and not args.paged:
        raise SystemExit("--tp/--mesh need --paged (the shard unit of the "
                         "distributed engine is the K/V page)")
    if tp is not None and tp > 1:
        return mesh_lib.spawn_or_join(_serve_rank, tp, (args,))
    return _serve(args, resolve_device(args.device), None)


def _serve_rank(rank: int, world: int, args):
    """One rank of ``--tp``: its device, the serving mesh over the group,
    and the run; ranks other than 0 print nothing."""
    device = mesh_lib.rank_device(rank, args.device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    mesh = mesh_lib.make_serving_mesh(world)
    if rank == 0:
        return _serve(args, device, mesh)
    with contextlib.redirect_stdout(io.StringIO()):
        return _serve(args, device, mesh)


def _serve(args, device, mesh):
    """Build the engine (on ``mesh`` when given), serve and report."""
    device = resolve_device(device)
    cfg = configs.get_smoke(args.arch) if args.smoke \
        else configs.get_config(args.arch)
    if cfg.encoder is not None or cfg.n_frontend_tokens:
        raise SystemExit("serve launcher demo supports decoder-only archs")
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = T.init_params(cfg, gen, device=device)
    tenants = [_parse_tenant(s) for s in args.tenant]
    n_pages = None
    if args.paged and args.pool_frac < 1.0:
        # At least the null page and one page: a tiny fraction gives a
        # tiny pool, not an error.
        n_pages = max(2, 1 + int(args.batch * args.max_len
                                 // args.page_size * args.pool_frac))
    scfg = ServeConfig(max_len=args.max_len, batch=args.batch,
                       paged=args.paged, page_size=args.page_size,
                       n_pages=n_pages, chunk_size=args.chunk_size,
                       temperature=args.temperature, seed=args.seed,
                       spec_k=args.spec_k, draft=args.draft,
                       prefix_cache=args.prefix_cache,
                       classes=tuple(slo for slo, _ in tenants) or None,
                       max_queue=args.max_queue,
                       max_preemptions=args.max_preemptions,
                       degrade=args.degrade,
                       spec_adapt_every=args.spec_probe_every,
                       spec_probe_every=args.spec_probe_every,
                       telemetry=not args.no_telemetry)
    engine = ServingEngine(params, cfg, scfg, device=device,
                           capture=mesh is None, mesh=mesh)
    del params          # under a mesh the engine keeps only this rank's shard
    if args.rate is not None:
        tcfg = traffic.TrafficConfig(
            rate=args.rate, n_requests=args.requests, seed=args.seed,
            process=args.process, burst_factor=args.burst_factor,
            vocab=cfg.vocab, max_prompt=args.max_len - args.max_new,
            classes=tuple(t for _, t in tenants) or
            (traffic.TrafficClass("default", out_lo=2,
                                  out_hi=max(2, args.max_new)),))
        arrivals = traffic.TrafficGenerator(tcfg).arrivals()
        inj = FaultInjector(canonical_schedule()) if args.faults else None
    else:
        rng = np.random.RandomState(args.seed)
        for rid in range(args.requests):
            prompt = rng.randint(2, cfg.vocab, size=rng.randint(4, 12))
            engine.submit(Request(rid=rid, prompt=prompt.astype(np.int32),
                                  max_new=args.max_new))
    if device.type == "cuda":
        torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    if args.rate is not None:
        res = traffic.run_open_loop(engine, arrivals, injector=inj)
        if inj is not None:
            inj.finish(engine)
        finished = engine.finished
    else:
        finished = engine.run_until_drained()
    if device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if args.rate is not None:
        _report(engine, arrivals, res, inj, dt, tcfg, args.process,
                args.rate)
    toks = sum(len(v) for v in finished.values())
    # Which constants priced this run's choose_* decisions: an operator
    # tells a stale calibration from a fresh one.
    const = engine.constants
    if const.source == "calibrated":
        age_min = max(0.0, (time.time() - const.timestamp) / 60.0)
        const_line = (f"  constants: calibrated [{const.backend}:"
                      f"{const.mesh}] priced choose_* (measured "
                      f"{age_min:.0f} min ago, ts={const.timestamp:.0f}; "
                      f"--default-constants forces the hand-set defaults)")
    else:
        const_line = ("  constants: hand-set defaults priced choose_* (run "
                      "python -m repro_torch.launch.calibrate to measure "
                      "this device)")
    print(f"served {len(finished)} requests, {toks} tokens in {dt:.2f}s "
          f"({toks / dt:.1f} tok/s) on {device}, "
          + (f"graphed (captured in {engine.capture_seconds:.2f}s)"
             if engine.graphed else "eager")
          + (f", tensor-parallel over {mesh_lib.describe(mesh)} (gloo; "
             f"its collectives are not captured)" if mesh is not None
             else "")
          + (f", sampled at temperature {args.temperature}"
             if args.temperature else ", greedy"))
    print(const_line)
    if args.paged:
        occ = engine.pool.occupancy()
        print(f"  paged: {occ['high_water']}/{occ['capacity']} pages "
              f"high-water ({args.page_size} rows each), chunk={engine.chunk}"
              f", {engine.chunk_steps} chunk steps, "
              f"{engine.admission_rejections} admission holds, "
              f"{engine.preemptions} preemptions, {engine.ticks} ticks")
        if mesh is not None:
            print(f"  pool sharded by pages over {engine.pool.n_devices} "
                  f"ranks, {engine.pool.block} pages each")
        if engine.prefix is not None:
            probes = engine.prefix_hits + engine.prefix_misses
            print(f"  prefix cache: {occ['pages_shared']} shared / "
                  f"{occ['pages_exclusive']} exclusive / "
                  f"{occ['pages_cached_idle']} cached-idle pages, index "
                  f"{len(engine.prefix)} entries, {engine.prefix_hits}/"
                  f"{probes} admissions hit, {engine.prefix_hit_pages} pages "
                  f"mapped, {engine.cow_copies} copy-on-write, "
                  f"{engine.prefix.evicted_pages} evicted")
        if engine.spec_k:
            ticks = max(1, engine.spec_ticks)
            print(f"  spec: k={engine.spec_k} draft={args.draft} "
                  f"accepted/tick={engine.spec_accepted / ticks:.2f} "
                  f"emitted/tick={engine.spec_emitted / ticks:.2f} "
                  f"({engine.verify_traces} verify step)"
                  + (f", k_live {engine.k_live}, {engine.spec_probes} "
                     f"trial ticks" if args.spec_probe_every else ""))
    else:
        print(f"  contiguous: {engine.ticks} ticks, prefill buckets "
              f"{dict(sorted(engine.prefill_buckets.items()))} (bucket: "
              f"prefills), {engine.decode_steps} decode steps")
    tel = engine.telemetry
    tstats = tel.tick_stats()
    if tstats["n"]:
        print(f"  telemetry: tick p50/p99 {tstats['p50_s'] * 1e3:.2f}/"
              f"{tstats['p99_s'] * 1e3:.2f} ms over {tstats['n']} ticks, "
              f"{len(tel.events)} events in ring ({tel.dropped_events} "
              f"evicted)")
        for name, st in sorted(tel.span_stats().items()):
            print(f"    span {name}: n={st['n']} exec-mean="
                  f"{st['execute_mean_s'] * 1e3:.2f} ms (first runs "
                  f"{st['compile_n']}x {st['compile_s'] * 1e3:.1f} ms)")
    if args.trace_out:
        with open(args.trace_out, "w") as f:
            json.dump(tel.chrome_trace(), f)
        print(f"  wrote {args.trace_out} (open at ui.perfetto.dev or "
              f"chrome://tracing)")
    print(f"  kernel launches: {dict(ops.LAUNCHES)}")
    for rid in sorted(finished):
        print(f"  req {rid}: {finished[rid][:10]}...")
    return finished


if __name__ == "__main__":
    main()
