"""Run one cell of ``BENCHMARK.json`` once and print its result as the
last line of standard output:

  python3 portbench/run.py --workload granite-3-8b.chat-closed192 \\
      --seed 1234 --seconds 30 --trace 0

In order: the kernels are built or loaded (``build/`` in the checkout),
the weights are made on the card from ``--seed``, the port's engine is
built with its steps captured as CUDA graphs, the cell's own shapes are
warmed up (a closed loop's first ``ramp_ticks`` ticks, an open loop's
burst of ``warmup_requests`` drained), the traffic runs for ``--seconds``,
the served tokens are judged against the plain reference, and one JSON
line is printed. ``--trace 1`` also profiles a slice of the window and
reports the per-layer metrics instead of the end-to-end ones.

Without a CUDA card, or with fewer than the cell asks for, the run exits
non-zero and prints no result. ``--rehearse`` runs the same path on the
CPU (the kernels' plain versions, a smoke-sized config) and prints only
what the program counts, never a device number.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
WARMUP_RID = 1 << 40


def cache_dirs(root: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout,
    so that only a checkout's first run of a cell builds."""
    build = root / "build"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(build / sub)
    os.environ["REPRO_TORCH_TUNING_CACHE"] = str(build / "tuning_cache.json")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card() -> dict:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip().splitlines()[0]
        name, limit = [s.strip() for s in out.split(",")]
        return {"smi_name": name, "power_limit": limit}
    except (OSError, subprocess.SubprocessError, IndexError, ValueError):
        return {"smi_name": "unknown", "power_limit": "unknown"}


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rehearse", action="store_true",
                    help="run on the CPU; report no device number")
    return ap.parse_args(argv)


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def execute(args, keep: bool = False, root: Path = ROOT):
    """One run of the cell ``args`` names in the checkout ``root``.
    Returns (exit code, the result line's object or None, and with
    ``keep`` what the check read: the weights, the judged requests, the
    cell, the device)."""
    for path in (str(root), str(root / "src")):
        if path not in sys.path:
            sys.path.insert(0, path)
    cache_dirs(root)
    from portbench import harness, judge, weights
    from portbench import traffic as traffic_mod

    cell = harness.load_cell(args.workload, root)
    import torch
    import repro_torch  # noqa: F401  (the program under test, or no run)

    chips = int(cell.workload.get("chips", 1))
    if not args.rehearse and not (torch.cuda.is_available()
                                  and torch.cuda.device_count() >= chips):
        log(f"{cell.name} needs {chips} CUDA card(s); this machine has "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
            f". No result.")
        return 2, None, None
    device = torch.device("cpu" if args.rehearse else "cuda")
    if not args.rehearse:
        torch.cuda.set_device(0)
        log(f"card: {torch.cuda.get_device_name(0)}; {card()}")
    spec, model = cell.spec, cell.model
    dtype = getattr(torch, model["compute_dtype"])
    params = weights.make(model, args.seed, device, dtype)
    engine = harness.build_engine(cell, params, device,
                                  telemetry=bool(args.trace))
    mix = traffic_mod.Mix(spec, args.seed, model["vocab"])
    driver = harness.Driver(engine, mix, spec)

    # Warm-up: this cell's shapes and none other.
    if mix.closed:
        driver.start()
        driver.run_ticks(int(spec.get("ramp_ticks", 0)))
    else:
        from repro_torch.serve.engine import Request
        warm = traffic_mod.Mix(spec, args.seed + 1, model["vocab"])
        for a in warm.take(int(spec.get("warmup_requests", 4))):
            engine.submit(Request(rid=WARMUP_RID + a.rid, prompt=a.prompt,
                                  max_new=a.max_new))
        engine.run_until_drained(max_ticks=100000)
    if device.type == "cuda":
        torch.cuda.synchronize()

    # The window.
    tracer, traced = None, {}
    if args.trace and not args.rehearse:
        from portbench import tracer as tracer_mod
        tracer = tracer_mod.Tracer()
        driver.annotate = tracer.record_function
    t0 = time.perf_counter()
    setup_s = t0 - T_START
    if not mix.closed:
        driver.start()
    counters0 = harness.engine_counters(engine)
    spans0 = engine.telemetry.span_stats()
    pool_use, decode_calls = [], []

    def sample(decode_rows):
        if args.trace and engine.pool is not None:
            pool_use.append(engine.pool.pages_in_use / engine.pool.capacity)
        if "ticks0" in traced and decode_rows:
            decode_calls.append((len(decode_rows),
                                 sum(c for _, c in decode_rows)))

    driver.hooks.append(sample)
    # A traced run profiles the window's last ``trace_seconds``; the
    # profiler stops after the window, so its work delays no request.
    end = t0 + args.seconds
    trace_from = end - float(spec.get("trace_seconds", 3.0))
    now = time.perf_counter()
    while now < end:
        if tracer is not None and "ticks0" not in traced \
                and now >= trace_from:
            tracer.start()
            traced["ticks0"] = engine.ticks
        now = driver.step(end)
    t1 = now
    if "ticks0" in traced:
        traced["ticks1"] = engine.ticks
        tracer.stop()
    driver.stop_submitting = True
    counters1 = harness.engine_counters(engine)
    spans1 = engine.telemetry.span_stats()
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0

    profile = tracer.read() if "ticks1" in traced else None
    if profile is not None:
        lo, hi = traced["ticks0"], traced["ticks1"]
        profile.decode_calls = decode_calls
        profile.chunk_calls = [
            (int(p["rid"]), int(p["start"]), int(p["rows"]))
            for _, tick, _, p in engine.telemetry.events_of("prefill_chunk")
            if lo < tick <= hi]
    run = harness.Run(cell=cell, setup_s=setup_s, t0=t0, t1=t1,
                      recs=driver.recs, esize=dtype.itemsize,
                      counters0=counters0, counters1=counters1,
                      spans0=spans0, spans1=spans1, pool_use=pool_use,
                      profile=profile)
    in_window = [r for r in driver.recs.values()
                 if r.submit_t < t1 and (r.done_t is None or r.done_t > t0)]
    failed = sum(1 for r in in_window
                 if r.outcome is not None and r.outcome != "done")
    finished = [(r.rid, r.prompt, list(r.req.generated))
                for r in driver.recs.values()
                if r.done_t is not None and r.done_t <= t1
                and r.outcome == "done"]
    late = max(driver.late, default=0.0)

    # The metrics, then the program's state freed before the reference.
    metrics = {}
    wanted = cell.per_layer if args.trace else cell.end_to_end
    for m in wanted:
        if args.rehearse and m["source"] != "program_counter":
            continue
        value = harness.reader(m["name"], root)(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    engine = driver = run = None
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    t_judge = time.perf_counter()
    jspec = spec["judge"]
    sampled = judge.sample(finished, args.seed, int(jspec["min_tokens"]))
    gaps = judge.served_gaps(params, cell.config, sampled, device)
    v = judge.verdict(gaps, jspec.get("limit"))
    bad = forbidden_modules()
    if bad:
        log(f"modules of the JAX side are loaded: {bad}. No result.")
        return 3, None, None

    result = {
        "correct": v["correct"],
        "attempted": len(in_window),
        "failed": failed,
        "metrics": metrics,
        "device": ({"platform": "cpu", "kind": "cpu", "count": 0,
                    "memory_peak_bytes": 0, "rehearsal": True}
                   if args.rehearse else
                   {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                    "count": chips, "memory_peak_bytes": int(peak)}),
    }
    if profile is not None:
        result["device"].update(busy_s=profile.busy_s,
                                window_s=profile.window_s)
        result["breakdown"] = {"device_ops": [list(x) for x in profile.ops],
                               "idle_gaps": [list(x) for x in profile.idle]}
    result["checks"] = {"max_gap": {"value": v["max_gap"],
                                    "limit": v["limit"]}}
    log(f"{cell.name} seed {args.seed}: window {t1 - t0:.3f} s, set-up "
        f"{setup_s:.3f} s, {len(in_window)} requests in the window, "
        f"{len(finished)} finished, {counters1['ticks'] - counters0['ticks']}"
        f" ticks, {counters1['preemptions'] - counters0['preemptions']}"
        f" preemptions, generator at most {late * 1e3:.3f} ms late; judged "
        f"{len(sampled)} requests, {v['tokens']} served tokens in "
        f"{time.perf_counter() - t_judge:.3f} s")
    log(f"check max_gap {v['max_gap']!r} limit {v['limit']!r} "
        f"({'correct' if v['correct'] else 'NOT correct'})")
    kept = dict(params=params, sampled=sampled, cell=cell,
                device=device) if keep else None
    return 0, result, kept


def main(argv=None) -> int:
    code, result, _ = execute(parse(argv))
    if result is not None:
        print(json.dumps(result), flush=True)
    return code


if __name__ == "__main__":
    sys.exit(main())
