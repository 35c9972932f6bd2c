"""device_idle_pct (device_idle_pct.live): the share
of the traced window in which no kernel and no copy ran on the card."""

from adsbench.yardstick.readers import idle_pct


def read(run):
    return idle_pct(run)
