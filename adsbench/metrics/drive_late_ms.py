"""drive_late_ms (drive_late_ms.live): the median over the window's blocks
of the drive's hand-over less the block's due time, ms (open drives): how
late the harness's drive woke, which every message's latency holds."""

import numpy as np


def read(run):
    if run.drive_late_s is None or not len(run.drive_late_s):
        return None
    return 1e3 * float(np.median(run.drive_late_s))
