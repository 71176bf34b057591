"""host_syncs.per_tick: the engine's blocking host<->device transfers and
reads a tick (its ``host_syncs`` counter over its ticks, both taken as
differences across the window); nothing where the engine does not count
them."""


def read(run):
    if "host_syncs" not in run.counters1:
        return None
    ticks = run.counters1["ticks"] - run.counters0["ticks"]
    if not ticks:
        return None
    syncs = run.counters1["host_syncs"] - run.counters0.get("host_syncs", 0)
    return syncs / ticks
