"""flash_decode_paged_roofline: the least time of the traced slice's
paged decode calls (``work.decode_least_s``: bytes over 3.35 TB/s against
FLOPs over 989 TFLOP/s, call by call) over their device time (the
profiler's ``flash_decode_paged`` family)."""

from portbench import work


def read(run):
    p = run.profile
    if p is None or not p.decode_calls:
        return None
    spent = p.family_s.get("flash_decode_paged", 0.0)
    if not spent:
        return None
    return 100.0 * work.decode_least_s(run) / spent
