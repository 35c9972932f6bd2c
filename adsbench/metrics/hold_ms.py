"""hold_ms (hold_ms.live): the runner's "hold" stage, host ms a block over
the window: from a block's end of dispatch to its start of fetch, the
depth-1 hold a message waits."""

from adsbench.yardstick.readers import stage_ms


def read(run):
    return stage_ms(run, "hold")
