"""latency_p95_ms (latency_p95_ms.live): the 95th percentile of
latency_p50_ms's latencies, a per-layer tail with no bound (the host's
pace spreads it wider from run to run than any bound may be)."""

import numpy as np


def read(run):
    if run.latencies_s is None or not len(run.latencies_s):
        return None
    return 1e3 * float(np.percentile(run.latencies_s, 95))
