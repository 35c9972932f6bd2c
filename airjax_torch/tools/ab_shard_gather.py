#!/usr/bin/env python3
"""Device time of the shard-gather kernel, for trees of the repository in
turns on one card:

  python3 airjax_torch/tools/ab_shard_gather.py OLD_TREE NEW_TREE NEW_TREE OLD_TREE

Each argument is a checkout's root (e.g. an unpacked `git archive` of
another commit, and `.`); each turn runs in a process of its own that
imports that tree's airjax_torch, builds its kernels and times
`kernels/shard_gather.py::shard_gather` on shard dicts laid out as the
block decode writes them (the valid slots first, offsets sorted, the six
extended classes one (6, K) block), at the shapes of `chip_smoke.py`'s
sharded decode: DF17 with D = 4, K = 2048, C = 8192 (a detection in 52% of
the slots, 95% of them good); extended with D = 4, K = C = 32,768 (33%
detections, half of them in a class); and extended with D = 1, K = C =
131,072, the whole-capture analysis. Each case is the profiler's device
time of `shard_gather_kernel`, 10 calls after a warm-up, three times, and
the median of 20 CUDA-event pairs around a call. Each turn also prints
the registers, stack and spills of the tree's `csrc/shard_gather.cu`
(`nvcc -Xptxas -v` with the build's flags). Prints one JSON line per turn
and the card's name and power limit.

  python3 airjax_torch/tools/ab_shard_gather.py --sass OLD_TREE NEW_TREE

compares the SASS of each instantiation of OLD's `shard_gather_kernel`
with NEW's of the same modes (and with every flag NEW adds false),
instructions with addresses and constants masked, as
tools/block_decode_sass.py does for the block-decode kernel; needs no card.
"""

from __future__ import annotations

import difflib
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile

CASES = (("df17_d4", False, 4, 2048, 8192, 0.52, 0.95), ("extended_d4", True, 4, 32768, 32768, 0.33, 0.5),
         ("extended_d1", True, 1, 131072, 131072, 0.33, 0.5))
BLOCK = (1 << 24) + 784


def shards(extended: bool, d: int, k: int, det: float, sel: float, device) -> list[dict]:
    import numpy as np
    import torch

    from airjax_torch.kernels.shard_gather import MASK_KEYS

    rng = np.random.default_rng(d * k)
    out = []
    for _ in range(d):
        n = int(det * k)
        valid = np.arange(k) < n
        offsets = np.zeros(k, np.int32)
        offsets[:n] = np.sort(rng.integers(0, BLOCK - 240, n))
        s = {"offsets": offsets, "valid": valid, "frames": rng.integers(0, 256, (k, 14), np.uint8),
             "n_detections": np.int32(n), "overflow": np.bool_(False)}
        picked = valid & (rng.random(k) < sel)
        if extended:
            s.update(frames_raw=rng.integers(0, 256, (k, 14), np.uint8), df=rng.integers(0, 25, k).astype(np.int32),
                     icao_ap_short=rng.integers(0, 1 << 24, k).astype(np.int32),
                     icao_ap_long=rng.integers(0, 1 << 24, k).astype(np.int32))
        else:
            s.update(good=picked, recovered=picked & (rng.random(k) < 0.01))
        t = {key: torch.as_tensor(v).to(device) for key, v in s.items()}
        if extended:
            classes = np.zeros((6, k), bool)
            classes[rng.integers(0, 6, k), np.arange(k)] = picked
            t.update(zip(MASK_KEYS, torch.as_tensor(classes).to(device).unbind(0)))
        out.append(t)
    return out


def ptxas(tree: str) -> list[str]:
    from airjax_torch import _build

    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
                               os.path.join(tmp, "sg.o"), os.path.join(tree, "airjax_torch", "csrc", "shard_gather.cu")],
                              capture_output=True, text=True, check=True)
    return [re.sub(r"'_ZN\S*shard_gather_kernel", "'shard_gather_kernel", ln.strip()) for ln in proc.stderr.splitlines()
            if "registers" in ln or "spill" in ln or "Compiling entry" in ln]


def one(tree: str) -> dict:
    sys.path.insert(0, tree)
    import torch
    from torch.profiler import ProfilerActivity, profile

    import airjax_torch
    from airjax_torch.kernels.shard_gather import shard_gather

    dev = torch.device("cuda")
    out = {"tree": tree, "package": airjax_torch.__file__, "device_us": {}, "events_us": {}, "ptxas": ptxas(tree)}
    for name, extended, d, k, c, det, sel in CASES:
        ins = shards(extended, d, k, det, sel, dev)
        max_offset = d * BLOCK - 240

        def fn(ins=ins, c=c, extended=extended, max_offset=max_offset):
            return shard_gather(ins, BLOCK, max_offset, c, extended=extended)

        times = []
        for _ in range(3):
            fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(10):
                    fn()
                torch.cuda.synchronize()
            ev = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA and "shard_gather_kernel" in e.name]
            times.append(sum(e.time_range.end - e.time_range.start for e in ev) / max(len(ev), 1))
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


def sass(old: str, new: str) -> int:
    """OLD's instantiations against NEW's with every added flag false."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from block_decode_sass import FLAGS, functions, toolkit

    found = []
    with tempfile.TemporaryDirectory() as tmp:
        for i, tree in enumerate((old, new)):
            obj = os.path.join(tmp, f"{i}.o")
            csrc = os.path.join(tree, "airjax_torch", "csrc")
            subprocess.run([toolkit("nvcc"), *FLAGS, f"-I{csrc}", "-c", "-o", obj, os.path.join(csrc, "shard_gather.cu")],
                           capture_output=True, text=True, check=True)
            kernels = {}
            for name, ins in functions(obj).items():
                m = re.search(r"shard_gather_kernelI((?:Lb[01]E)+)E", name)
                if m:
                    flags = re.findall(r"Lb([01])E", m.group(1))
                    kernels[tuple(flags)] = ins
            found.append(kernels)
    same = True
    for flags, ins in sorted(found[0].items()):
        extra = max(len(f) for f in found[1]) - len(flags)
        mine = found[1][flags + ("0",) * extra]
        renamed = sorted(re.sub(r"\bU?R\d+", "R", x) for x in ins) == sorted(re.sub(r"\bU?R\d+", "R", x) for x in mine)
        print(f"modes {flags}: {old} {len(ins)} instructions, {new} {len(mine)}; the same: {ins == mine}; "
              f"the same instructions up to registers and order: {renamed}")
        if ins != mine:  # the first differences, to see what moved
            diff = [ln for ln in difflib.unified_diff(ins, mine, old, new, n=0, lineterm="") if ln[:1] in "+-"]
            print("\n".join(f"  {ln}" for ln in diff[2:14]))
        same &= ins == mine
    return 0 if same else 1


def main(argv: list[str]) -> int:
    if argv[:1] == ["--sass"]:
        return sass(*argv[1:3])
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
