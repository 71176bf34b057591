"""chunk_device_ms.mean: the mean device time of a prompt chunk's graph
replay over the window (the engine's ``prefill_chunk.replay.device`` span,
timed by events its captured graph records as its first and last node; a
traced run, telemetry on); nothing where the engine has no such span."""


def read(run):
    name = "prefill_chunk.replay.device"
    a, b = run.spans0.get(name), run.spans1.get(name)
    if not b:
        return None
    n = b["n"] - (a["n"] if a else 0)
    if not n:
        return None
    return (b["total_s"] - (a["total_s"] if a else 0.0)) / n * 1e3
