#!/usr/bin/env python3
"""Which kernel launches torch.profiler loses from its windows, in a
process of its own:

  python3 airjax_torch/tools/profile_drops.py

On one card, at the shapes of chip_smoke.py's sharded step: a 2^26-sample
DF17 capture on 4 shards of the card (2^24 + 784 samples a shard), K 2048,
C 8192, so a step launches, in order, a front and a block decode a shard
(F D F D F D F D) and one shard gather (G). WINDOWS profiler windows of
one step each. Prints one JSON line: the windows that recorded the whole
step, the first window that did not, and each partial launch order with
its count; then the card's name and power limit. (Late in a long process,
with CUPTI kept attached between windows, the profiler loses a window's
first launches; this tool sees whether a fresh process does too.
`chip_smoke.py` sets TEARDOWN_CUPTI=1, which attaches CUPTI anew for each
window.)
"""

from __future__ import annotations

import collections
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

SHARDS, SAMPLES, K, C, WINDOWS = 4, 1 << 26, 2048, 8192, 150
LETTER = {"magdet_bits_kernel": "F", "block_decode_kernel": "D", "shard_gather_kernel": "G"}


def window(fn) -> str:
    """The launches one profiler window recorded of one call of fn, in
    order, as letters."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    return "".join(letter for e in events for name, letter in LETTER.items() if name in e.name)


def main() -> int:
    from airjax_torch import pipeline
    from airjax_torch.parallel import halo
    from airjax_torch.parallel.mesh import Mesh

    if not torch.cuda.is_available():
        print("profile_drops: no card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    iq = rng.normal(0, 60, (SAMPLES, 2)).astype(np.int16)
    block = halo.tuned_block(-(-SAMPLES // SHARDS))
    mesh = Mesh([dev] * SHARDS)
    shards = halo.shard_iq(pipeline.pad_iq_non_detecting(iq, block * SHARDS), mesh, block, halo._halo_size(block))
    step = halo.build_sharded_decoder_compact(mesh, block * SHARDS, K, C)
    step(shards)
    torch.cuda.synchronize()
    whole = "FD" * SHARDS + "G"
    orders = [window(lambda: step(shards)) for _ in range(WINDOWS)]
    partial = [i for i, o in enumerate(orders) if o != whole]
    print(json.dumps({"windows": WINDOWS, "whole": WINDOWS - len(partial),
                      "first partial window": partial[0] if partial else None,
                      "partial launch orders": collections.Counter(orders[i] for i in partial)}))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60)
    print(card.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
