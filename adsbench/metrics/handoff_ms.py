"""handoff_ms (handoff_ms.live): the runner's "handoff" stage, host ms a
block over the window: from the prefetch thread's getting the block from
the source to the block loop's receipt of it."""

from adsbench.yardstick.readers import stage_ms


def read(run):
    return stage_ms(run, "handoff")
