"""mfu.prefill: the model FLOPs of every row the traced slice processed
(``work.model_flops``) over 989 TFLOP/s times the seconds in which an
operation ran on the device: what the device makes of its busy time."""

from portbench import peaks, work


def read(run):
    p = run.profile
    if p is None or not p.busy_s:
        return None
    flops = work.model_flops(run)
    if not flops:
        return None
    return 100.0 * flops / (peaks.H100_SXM["bf16_flops"] * p.busy_s)
