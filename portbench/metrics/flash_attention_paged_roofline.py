"""flash_attention_paged_roofline: the least time of the traced slice's
paged prefill chunks (``work.prefill_least_s``) over their device time
(the profiler's ``flash_attention_paged`` family)."""

from portbench import work


def read(run):
    p = run.profile
    if p is None or not p.chunk_calls:
        return None
    spent = p.family_s.get("flash_attention_paged", 0.0)
    if not spent:
        return None
    return 100.0 * work.prefill_least_s(run) / spent
