"""carry_ms (carry_ms.live): the runner's "carry" stage, host ms a block
over the window: the block's asarray, the short-read join, the carry's
concatenate and copy."""

from adsbench.yardstick.readers import stage_ms


def read(run):
    return stage_ms(run, "carry")
