"""The knee of an open-loop cell: its traffic offered at several rates in
turn, one process on one card, each window followed by a drain, with the
backlog (requests due but not yet given a first token) read at each
quarter of the window. The knee is the highest rate at which the backlog
does not grow over the window.

  python3 portbench/sweep.py --workload granite-3-8b.rag-open \\
      --seed 11 --seconds 20 --rates 4 6 8 10 12 14

Prints one JSON line a rate; run it on the card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from portbench import harness, run, weights
    from portbench import traffic as traffic_mod
    import numpy as np
    import torch

    run.cache_dirs(ROOT)
    if not torch.cuda.is_available():
        print("the sweep runs on a CUDA card", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload, ROOT)
    model = cell.model
    params = weights.make(model, args.seed, torch.device("cuda"),
                          getattr(torch, model["compute_dtype"]))
    engine = harness.build_engine(cell, params, torch.device("cuda"),
                                  telemetry=False)
    print(json.dumps({"card": torch.cuda.get_device_name(0), **run.card()}),
          flush=True)
    from repro_torch.serve.engine import Request
    warm = traffic_mod.Mix(cell.spec, args.seed + 1000, model["vocab"])
    for a in warm.take(int(cell.spec.get("warmup_requests", 4))):
        engine.submit(Request(rid=run.WARMUP_RID + a.rid, prompt=a.prompt,
                              max_new=a.max_new))
    engine.run_until_drained(max_ticks=100000)
    for i, rate in enumerate(args.rates):
        mix = traffic_mod.Mix(cell.spec, args.seed + i, model["vocab"],
                              rate=rate)
        drv = harness.Driver(engine, mix, cell.spec)
        drv.start()
        t0 = drv.start_t
        marks, now = [], time.perf_counter()
        for q in (0.25, 0.5, 0.75, 1.0):
            now = drv.run_for(t0 + q * args.seconds - now) \
                if now < t0 + q * args.seconds else now
            backlog = sum(1 for r in drv.recs.values()
                          if r.due <= now and (r.first_t is None
                                               or r.first_t > now))
            marks.append(backlog)
        t1 = now
        r = harness.Run(cell=cell, setup_s=0.0, t0=t0, t1=t1, recs=drv.recs,
                        esize=2)
        ttft = harness.reader("ttft_p95_ms", ROOT)(r)
        due = r.due_in_window()
        ages = [((x.first_t if x.first_t is not None and x.first_t <= t1
                  else t1) - x.due) * 1e3 for x in due]
        tok = harness.reader("tok_s", ROOT)(r)
        itl = harness.reader("itl_p95_ms", ROOT)(r)
        drv.drain()
        print(json.dumps({
            "rate": rate, "window_s": t1 - t0, "due": len(due),
            "backlog_at_quarters": marks,
            "ttft_p50_ms": float(np.percentile(ages, 50)) if ages else None,
            "ttft_p95_ms": ttft, "itl_p95_ms": itl, "tok_s": tok,
            "generator_late_ms_max": max(drv.late, default=0.0) * 1e3}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
