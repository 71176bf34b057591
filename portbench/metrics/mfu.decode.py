"""mfu.decode: the model FLOPs of every row the traced slice processed
(``work.model_flops``) over 989 TFLOP/s (bf16, the H100 SXM at 700 W)
times the slice's wall seconds: the whole step's share of the peak."""

from portbench import peaks, work


def read(run):
    p = run.profile
    if p is None or not p.window_s:
        return None
    flops = work.model_flops(run)
    if not flops:
        return None
    return 100.0 * flops / (peaks.H100_SXM["bf16_flops"] * p.window_s)
