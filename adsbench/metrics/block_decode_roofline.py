"""block_decode_roofline: the block-decode kernel's least time by
the bytes its block and candidates need (yardstick.bounds.block_decode_bytes,
the window's gate passes a block) over its device time, summed over its
launches in the traced window."""

from adsbench.yardstick import bounds
from adsbench.yardstick.readers import roofline_pct


def read(run):
    n_bytes = bounds.block_decode_bytes(run.block_shape[1], run.detections_a_block, run.extended, run.fields)
    return roofline_pct(run, "block_decode_kernel", n_bytes)
