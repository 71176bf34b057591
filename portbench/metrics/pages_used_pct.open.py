"""pages_used_pct.open: the page pool's pages in use over its capacity in
an open-loop cell, the mean over the window's ticks
(``PageAllocator.pages_in_use``, read after each tick of a traced run);
a pool that fills holds new prompts back, which moves their first token."""


def read(run):
    if not run.pool_use:
        return None
    return 100.0 * sum(run.pool_use) / len(run.pool_use)
