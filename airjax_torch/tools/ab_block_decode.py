#!/usr/bin/env python3
"""Device time of the block-decode kernel without recover2, for two trees
of the repository in turns on one card:

  python3 airjax_torch/tools/ab_block_decode.py OLD_TREE NEW_TREE NEW_TREE OLD_TREE

Each argument is a checkout's root (e.g. an unpacked `git archive` of the
parent commit, and `.`); each turn runs in a process of its own that
imports that tree's airjax_torch, builds its kernels and times
`kernels/block_decode.py::decode_block_bits` in both modes on the blocks
of chip_smoke.py's phases 4 and 7 (2^24 + 1024 samples; K = 2048 for 1024
DF17 frames, and the preamble detections rounded up to 1024 for 1024
aircraft of every format): the profiler's device time of
`block_decode_kernel`, 10 calls after a warm-up, three times. Prints one
JSON line per turn and the card's name and power limit.
"""

from __future__ import annotations

import json
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
    from airjax_torch.kernels.block_decode import decode_block_bits
    from airjax_torch.kernels.magdet import magdet_bits, magdet_plain

    dev = torch.device("cuda")
    n_off = BLOCK - 240
    rng = np.random.default_rng(0)
    offs = np.sort(rng.choice(np.arange(0, n_off // 300) * 300, 1024, replace=False))
    frames = [synth.make_df17(int(rng.integers(1, 1 << 24)), synth.make_id_me(f"AB{i:05d}")) for i in range(1024)]
    df17 = torch.as_tensor(synth.modulate(frames, list(map(int, offs)), BLOCK + 1024, noise_std=60.0, seed=0)).to(dev)
    mixed = synth.make_mixed_frames(1024, 30)
    offs = np.sort(rng.choice(np.arange(0, n_off // 300) * 300, len(mixed), replace=False))
    ext = torch.as_tensor(synth.modulate(mixed, list(map(int, offs)), BLOCK + 1024, noise_std=60.0, seed=30)).to(dev)
    k_ext = -(-int(magdet_plain(ext, n_off, gate="preamble")[0].sum()) // 1024) * 1024
    out = {"tree": tree, "package": airjax_torch.__file__, "device_us": {}}
    for mode, iq, gate, k, extended in (("df17", df17, "df17", 2048, False), ("extended", ext, "preamble", k_ext, True)):
        det_words, words, counts = magdet_bits(iq, n_off, gate)

        def fn():
            return decode_block_bits(det_words, words, counts, n_off, k, extended=extended)

        times = []
        for _ in range(3):
            fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(10):
                    fn()
                torch.cuda.synchronize()
            ev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                  and "block_decode_kernel" in e.name]
            times.append(sum(e.time_range.end - e.time_range.start for e in ev) / max(len(ev), 1))
        out["device_us"][mode] = times
        out.setdefault("k", {})[mode] = k
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
