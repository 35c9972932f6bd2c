#!/usr/bin/env python3
"""Device time of the block-decode kernel, for two trees of the repository
in turns on one card:

  python3 airjax_torch/tools/ab_block_decode.py OLD_TREE NEW_TREE NEW_TREE OLD_TREE

Each argument is a checkout's root (e.g. an unpacked `git archive` of the
parent commit, and `.`); each turn runs in a process of its own that
imports that tree's airjax_torch, builds its kernels and times
`kernels/block_decode.py::decode_block_bits` on three blocks of 2^24 + 1024
samples: 1024 DF17 frames (K = 2048), the same with 256 of them sent with a
2-bit flip (the recover2 block, K = 2048), and 1024 aircraft of every
format (the preamble detections rounded up to 1024). Per block, both modes
where they apply, without and with recover2 (R2), and the batched pass's
block decode: where the tree has the F flag (`decode_block_bits(...,
fields=True)`) that one launch, else the block decode followed by the
fields kernel (`kernels/fields.py::block_fields`), the sum of both. Each
is the profiler's device time of `block_decode_kernel` (and
`fields_kernel`), 10 calls after a warm-up, three times, and the median of
20 CUDA-event pairs around a call (`events_us`: the wrappers' host time
included). Prints one JSON line per turn and the card's name and power
limit.
"""

from __future__ import annotations

import inspect
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
    from airjax_torch.kernels.block_decode import decode_block_bits
    from airjax_torch.kernels.fields import block_fields
    from airjax_torch.kernels.magdet import magdet_bits, magdet_plain

    dev = torch.device("cuda")
    n_off = BLOCK - 240
    rng = np.random.default_rng(0)

    def df17_block(n_two: int, seed: int):
        offs = np.sort(rng.choice(np.arange(0, n_off // 300) * 300, 1024, replace=False))
        frames = [synth.make_df17(int(rng.integers(1, 1 << 24)), synth.make_id_me(f"AB{i:05d}")) for i in range(1024)]
        for i in rng.choice(1024, n_two, replace=False):
            for b in rng.choice(np.arange(5, 88), 2, replace=False):
                frames[i] = synth.flip_bit(frames[i], int(b))
        iq = synth.modulate(frames, list(map(int, offs)), BLOCK + 1024, noise_std=60.0, seed=seed)
        return torch.as_tensor(iq).to(dev)

    df17, r2 = df17_block(0, 0), df17_block(256, 2)
    mixed = synth.make_mixed_frames(1024, 30)
    offs = np.sort(rng.choice(np.arange(0, n_off // 300) * 300, len(mixed), replace=False))
    ext = torch.as_tensor(synth.modulate(mixed, list(map(int, offs)), BLOCK + 1024, noise_std=60.0, seed=30)).to(dev)
    k_ext = -(-int(magdet_plain(ext, n_off, gate="preamble")[0].sum()) // 1024) * 1024
    has_f = "fields" in inspect.signature(decode_block_bits).parameters
    out = {"tree": tree, "package": airjax_torch.__file__, "batched": "F flag" if has_f else "block decode + fields",
           "device_us": {}, "events_us": {}, "k": {}}
    cases = (("df17", df17, "df17", 2048, False, False), ("df17_r2", r2, "df17", 2048, False, True),
             ("extended", ext, "preamble", k_ext, True, False), ("extended_r2", ext, "preamble", k_ext, True, True))
    for name, iq, gate, k, extended, recover2 in cases:
        det_words, words, counts = magdet_bits(iq, n_off, gate)
        args = (det_words, words, counts, n_off, k)

        def plain_pass(args=args, extended=extended, recover2=recover2):
            return decode_block_bits(*args, extended=extended, recover2=recover2)

        def batched_pass(args=args, extended=extended, recover2=recover2):
            if has_f:
                return decode_block_bits(*args, extended=extended, recover2=recover2, fields=True)
            d = decode_block_bits(*args, extended=extended, recover2=recover2)
            return block_fields(d["frames"], d["frames_raw"] if extended else None)

        for key, fn in ((name, plain_pass), (f"{name}_batched", batched_pass)):
            times = []
            for _ in range(3):
                fn()
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(10):
                        fn()
                    torch.cuda.synchronize()
                ev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                      and ("block_decode_kernel" in e.name or "fields_kernel" in e.name)]
                passes = sum("block_decode_kernel" in e.name for e in ev)
                times.append(sum(e.time_range.end - e.time_range.start for e in ev) / max(passes, 1))
            out["device_us"][key] = times
            events = []
            for _ in range(20):
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                fn()
                end.record()
                end.synchronize()
                events.append(start.elapsed_time(end) * 1e3)
            out["events_us"][key] = statistics.median(events)
        out["k"][name] = k
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
