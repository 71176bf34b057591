"""device_idle_pct.engine: the share of the window in which the device was
idle by the engine's own clock: the ``idle.*`` seconds the engine charged
over the window (``serve/telemetry.py``: the gaps between its device
spans, timed by CUDA events and settled onto the host clock at the reads
the engine already makes) over the window's seconds. A traced run
(telemetry on); nothing where the engine records no idle."""


def _idle_s(spans) -> float:
    return sum(st["total_s"] for name, st in spans.items()
               if name.startswith("idle."))


def read(run):
    if not any(name.startswith("idle.") for name in run.spans1):
        return None
    return 100.0 * (_idle_s(run.spans1) - _idle_s(run.spans0)) / run.seconds
