"""decode_step_ms.mean: the mean of the engine's ``decode`` span over the
window's decode steps (telemetry on, a traced run). The span ends with
the step's read of its picks, so it holds the device's work."""


def read(run):
    a, b = run.spans0.get("decode"), run.spans1.get("decode")
    if not b:
        return None
    n = b["n"] - (a["n"] if a else 0)
    if not n:
        return None
    return (b["total_s"] - (a["total_s"] if a else 0.0)) / n * 1e3
