"""decode_batch.mean: live rows a decode step, over the window: the
engine's ``decode_slot_ticks`` counter over its ``decode_steps``, both
taken as differences across the window (exact with telemetry off)."""


def read(run):
    steps = run.counters1["decode_steps"] - run.counters0["decode_steps"]
    if not steps:
        return None
    rows = run.counters1.get("decode_slot_ticks", 0) - \
        run.counters0.get("decode_slot_ticks", 0)
    return rows / steps
