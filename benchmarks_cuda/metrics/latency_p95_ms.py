"""latency_p95_ms: the 95th percentile, over every request of the window,
of the host-clock time from a request's issue to its rows on the host. In
a closed loop a request is one ``search_batch`` call."""

import numpy as np


def read(run):
    if not run.latencies_s:
        return None
    return float(np.percentile(np.asarray(run.latencies_s) * 1e3, 95))
