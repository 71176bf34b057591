"""queue_wait_ms.p95: the 95th percentile, over every request due inside
the window, of the engine's wall-clock queue wait: from its submission
stamp to its first admission's (``Request.submit_t``, ``admit_t``; a
traced run, telemetry on). A request not admitted when the window closes
counts at its wait so far. Nothing where the engine stamps no request."""

import numpy as np


def read(run):
    waits = []
    for r in run.due_in_window():
        sub = getattr(r.req, "submit_t", None)
        if sub is None:
            continue
        adm = getattr(r.req, "admit_t", None)
        waits.append((adm if adm is not None and adm <= run.t1
                      else run.t1) - sub)
    if not waits:
        return None
    return float(np.percentile(np.asarray(waits), 95)) * 1e3
