"""itl_p95_ms: the 95th percentile over every gap between consecutive
output tokens of a request, both inside the window, each token stamped
by the host clock after the tick that delivered it."""

import numpy as np


def read(run):
    gaps = run.itl_gaps()
    if not gaps:
        return None
    return float(np.percentile(np.asarray(gaps), 95)) * 1e3
