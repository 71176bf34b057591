"""Calibration launcher: probe the serving path's cost constants on the
device and persist them for the engine's ``choose_*`` decisions.

  python -m repro_torch.launch.calibrate                 # on the card
  python -m repro_torch.launch.calibrate --fast          # fewer trials
  python -m repro_torch.launch.calibrate --device cpu --fast --no-persist

Each probe prints its measured value beside the hand-set assumption it
replaces and the drift ratio between them; the last line says which
constants ``resolve_constants`` now returns for the device. The cache is
the port's own (``core.autotune.TUNING_CACHE_PATH``, under ``build/``, or
``$REPRO_TORCH_TUNING_CACHE``). ``REPRO_DEFAULT_CONSTANTS=1`` (the serve
launcher's ``--default-constants``) keeps the defaults.
"""

from __future__ import annotations

import argparse
import json
import time

from repro_torch import resolve_device
from repro_torch.core import autotune, calibrate


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fast", action="store_true",
                    help="fewer trials and a shorter sweep")
    ap.add_argument("--no-persist", action="store_true",
                    help="measure and report without writing the cache")
    ap.add_argument("--json", action="store_true",
                    help="print the calibration report as JSON")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    backend = device.type
    persist = not args.no_persist
    t0 = time.time()
    results = calibrate.run_calibration(fast=args.fast, persist=persist,
                                        device=device)
    elapsed = time.time() - t0
    assumed = autotune.assumed_constants()

    if args.json:
        report = autotune.calibration_report(backend=backend)
        report["probe_details"] = {
            n: dict(value=r.value, unit=r.unit, n_trials=r.n_trials,
                    spread=r.spread, **r.detail)
            for n, r in results.items()}
        print(json.dumps(report, indent=2, sort_keys=True, default=str))
    else:
        print(f"== calibration [{backend}:{autotune._mesh_key(None)}] "
              f"{elapsed:.1f}s ==")
        print(f"{'constant':18s} {'measured':>12s} {'assumed':>12s} "
              f"{'drift':>8s} {'unit':>10s} {'n':>4s} {'spread':>7s}")
        for name, r in results.items():
            drift = autotune.drift_ratio(r.value, assumed[name])
            print(f"{name:18s} {r.value:12.4e} {assumed[name]:12.4e} "
                  f"{drift:8.2f} {r.unit:>10s} {r.n_trials:4d} "
                  f"{r.spread:7.2f}")

    resolved = autotune.resolve_constants(backend=backend)
    if persist:
        assert resolved.source == "calibrated", resolved
        assert len(results) >= 5, sorted(results)
    if not args.json:
        verb = "persisted; engine decisions now price from" \
            if persist else "not persisted; engines keep"
        print(f"constants {verb} the '{resolved.source}' set "
              f"(backend={resolved.backend or backend}, "
              f"ts={resolved.timestamp:.0f})")
    return results


if __name__ == "__main__":
    main()
