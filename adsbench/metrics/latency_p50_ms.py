"""latency_p50_ms: the median over the window's messages (each packet a
per-packet sink took, each message a batched tracker took) of the time
the sink call that received it returned, less the due time of the block
that holds the frame's last window sample (open drives only)."""

import numpy as np


def read(run):
    if run.latencies_s is None or not len(run.latencies_s):
        return None
    return 1e3 * float(np.percentile(run.latencies_s, 50))
