"""pages_used_pct: the page pool's pages in use over its capacity, the
mean over the window's ticks (``PageAllocator.pages_in_use``, read after
each tick of a traced run)."""


def read(run):
    if not run.pool_use:
        return None
    return 100.0 * sum(run.pool_use) / len(run.pool_use)
