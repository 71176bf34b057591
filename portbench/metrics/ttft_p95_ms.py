"""ttft_p95_ms: the 95th percentile, over every request due inside the
window, of the time from when it was due to when its first token reached
the host. A request with no first token when the window closes counts at
its age at the close, so a backlog or a stall shows."""

import numpy as np


def read(run):
    due = run.due_in_window()
    if not due:
        return None
    ages = [(r.first_t if r.first_t is not None and r.first_t <= run.t1
             else run.t1) - r.due for r in due]
    return float(np.percentile(np.asarray(ages), 95)) * 1e3
