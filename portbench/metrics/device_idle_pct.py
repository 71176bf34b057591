"""device_idle_pct: the share of the traced slice's wall time in which no
operation ran on the device (the profiler's kernels, copies and sets)."""


def read(run):
    p = run.profile
    if p is None or not p.window_s:
        return None
    return 100.0 * (1.0 - p.busy_s / p.window_s)
