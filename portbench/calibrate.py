"""The readings a cell's correctness limit is set from, on the card: for
each seed, one whole run of the cell (``run.execute``: the window at the
cell's own load, the sample judged against the fp32 reference), and for
the first ``--control`` seeds the control's reading on the same sample:
the reference with every matrix product's inputs in fp8 (one per-tensor
scale), put in the program's place, the gap of the token it puts first.

  python3 portbench/calibrate.py --workload granite-3-8b.rag-open \\
      --seconds 30 --seeds 101 102 103 --control 3

Prints one JSON line a seed. The limit goes between the largest sound
reading and the smallest control reading (``traffic/<cell>.json``,
``judge.limit``); PERF.md keeps the readings.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=3)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from portbench import judge, run
    import torch

    for i, seed in enumerate(args.seeds):
        code, result, kept = run.execute(run.parse(
            ["--workload", args.workload, "--seed", str(seed), "--seconds",
             str(args.seconds), "--trace", "0"]), keep=True)
        if code:
            return code
        row = {"seed": seed, "max_gap": result["checks"]["max_gap"]["value"],
               "tokens": sum(len(t) for _, _, t in kept["sampled"]),
               "requests": len(kept["sampled"]),
               "metrics": {k: v["value"] for k, v in result["metrics"].items()}}
        if i < args.control:
            gaps = judge.control_gaps(kept["params"], kept["cell"].config,
                                      kept["sampled"], kept["device"])
            row["control_max_gap"] = float(gaps.max())
            row["control_median_gap"] = float(gaps.median())
            row["control_share_off_best"] = float((gaps > 0).float().mean())
        print(json.dumps(row), flush=True)
        kept = result = None
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
