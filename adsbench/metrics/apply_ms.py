"""apply_ms (apply_ms.live): the runner's "apply" stage, host ms a block over the window."""

from adsbench.yardstick.readers import stage_ms


def read(run):
    return stage_ms(run, "apply")
