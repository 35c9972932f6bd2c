"""front_roofline: the front kernel's least time by its bytes
(yardstick.bounds.front_bytes of the block's shape) over its device time,
summed over its launches in the traced window."""

from adsbench.yardstick import bounds
from adsbench.yardstick.readers import roofline_pct


def read(run):
    return roofline_pct(run, "magdet_bits_kernel", bounds.front_bytes(*run.block_shape))
