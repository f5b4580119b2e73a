"""95th percentile of every request's latency in the window, from its
issue to its synchronised result (host clock)."""

import numpy as np


def read(run):
    if not run.latencies:
        return None
    return float(np.percentile(np.asarray(run.latencies) * 1e3, 95))
