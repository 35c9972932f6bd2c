"""latency_p95_ms: the 95th percentile of latency_p50_ms's latencies."""

import numpy as np


def read(run):
    if run.latencies_s is None or not len(run.latencies_s):
        return None
    return 1e3 * float(np.percentile(run.latencies_s, 95))
