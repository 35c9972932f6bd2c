#!/usr/bin/env python3
"""Device time of the planes contract (`magdet(..., packed=False)` and
`magdet_tree`), for trees of the repository in turns on one card:

  python3 airjax_torch/tools/ab_planes.py OLD_TREE NEW_TREE NEW_TREE OLD_TREE

Each argument is a checkout's root (an unpacked `git archive` of another
commit, `.`, or a variant under build/exp/); each turn runs in a process
of its own that imports that tree's airjax_torch, builds its kernels and
times, on one block of 2^24 + 1024 samples (1024 DF17 frames at multiples
of 300, noise 60, seed 0): `magdet(packed=False)` with both gates,
`magdet_tree` in its three variants, and `magdet_bits` (the same gate,
bits out). Whatever kernel a tree's wrapper launches is timed: in a tree
with csrc/planes.cu that is its forms, in an older one csrc/magdet.cu.
Each is the profiler's device time of every kernel a call launches, 10
calls after a warm-up, three times, and the median of 20 CUDA-event pairs
around a call (`events_us`: the wrappers' host time included). Prints one
JSON line per turn and the card's name and power limit.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys

BLOCK = 1 << 24


def one(tree: str) -> dict:
    sys.path.insert(0, tree)
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import airjax_torch
    from airjax_torch.io import synth
    from airjax_torch.kernels.magdet import magdet, magdet_bits
    from airjax_torch.kernels.stencil3 import magdet_tree

    n_off = BLOCK - 240
    rng = np.random.default_rng(0)
    offs = np.sort(rng.choice(np.arange(0, n_off // 300) * 300, 1024, replace=False))
    frames = [synth.make_df17(int(rng.integers(1, 1 << 24)), synth.make_id_me(f"AB{i:05d}")) for i in range(1024)]
    iq = torch.as_tensor(synth.modulate(frames, list(map(int, offs)), BLOCK + 1024, noise_std=60.0, seed=0)).cuda()
    calls = {"front": lambda: magdet(iq, n_off, packed=False),
             "front_preamble": lambda: magdet(iq, n_off, packed=False, gate="preamble"),
             **{v: (lambda v=v: magdet_tree(iq, n_off, v)) for v in ("tree32", "tree16", "flat16")},
             "magdet_bits": lambda: magdet_bits(iq, n_off)}
    out = {"tree": tree, "package": airjax_torch.__file__, "device_us": {}, "events_us": {}}
    for name, fn in calls.items():
        times = []
        for _ in range(3):
            fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(10):
                    fn()
                torch.cuda.synchronize()
            ev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
            times.append(sum(e.time_range.end - e.time_range.start for e in ev) / 10)
        out["device_us"][name] = times
        events = []
        for _ in range(20):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            events.append(start.elapsed_time(end) * 1e3)
        out["events_us"][name] = statistics.median(events)
    return out


def main(argv: list[str]) -> int:
    if argv[:1] == ["--one"]:
        print(json.dumps(one(argv[1])))
        return 0
    for tree in argv:
        proc = subprocess.run([sys.executable, __file__, "--one", tree], capture_output=True, text=True, timeout=600)
        if proc.returncode:
            print(proc.stdout, proc.stderr, file=sys.stderr)
            return proc.returncode
        print(proc.stdout.strip().splitlines()[-1])
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60)
    print(card.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
