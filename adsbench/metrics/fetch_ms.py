"""fetch_ms (fetch_ms.live): the runner's "fetch" stage, host ms a block over the window."""

from adsbench.yardstick.readers import stage_ms


def read(run):
    return stage_ms(run, "fetch")
