"""tok_s: output tokens that reached the host inside the window, over the
window's seconds (the window ends with the tick that crosses its end)."""


def read(run):
    n = sum(1 for t in run.token_times() if run.t0 < t <= run.t1)
    return n / run.seconds
