#!/usr/bin/env python3
"""MS/s of the sharded batched streams, for trees of the repository in
turns on one card:

  python3 airjax_torch/tools/ab_sharded_stream.py OLD_TREE NEW_TREE NEW_TREE OLD_TREE

Each argument is a checkout's root (e.g. an unpacked `git archive` of
another commit, and `.`); each turn runs in a process of its own that
imports that tree's airjax_torch and streams one capture through
`runner.run_stream_sharded` on 4 shards of card 0, in 20,000-sample
blocks, into `BatchTracker`, `BatchTracker` with recover2 and
`ExtendedBatchTracker`: the batched sinks, whose steps gather the rows'
fields (with the gather kernel's flag F where the tree has it, else the
gather and then the fields kernel). The capture is 2^24 samples at 2 MS/s
made from a seed: 400 aircraft, each sending identification and
airborne-position squitters and DF11, DF4 and DF5 replies at random
offsets 300 samples apart or more, about ten frames a block. Each sink is
timed three times after a warm-up (MS/s, host included, from numpy; the
median is reported) and its launches counted once. Prints one JSON line
per turn and the card's name and power limit.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

SAMPLES = 1 << 24
BLOCK = 20_000
AIRCRAFT = 400


def capture():
    import numpy as np

    from airjax_torch.io import synth
    from airjax_torch.protocol import shortframe

    rng = np.random.default_rng(10)
    icaos = rng.choice(np.arange(0x100000, 0xF00000), AIRCRAFT, replace=False)
    offsets = np.sort(rng.choice(np.arange(0, (SAMPLES - 240) // 300) * 300, SAMPLES // 2000, replace=False))
    frames = []
    for i in range(len(offsets)):
        icao = int(icaos[rng.integers(AIRCRAFT)])
        kind = i % 5
        if kind == 0:
            frames.append(synth.make_df17(icao, synth.make_id_me(f"AB{icao % 100000:05d}")))
        elif kind == 1:
            frames.append(synth.make_df17(icao, synth.make_position_me(
                11, 1000 + 25 * int(rng.integers(0, 1500)), int(rng.integers(0, 1 << 17)),
                int(rng.integers(0, 1 << 17)), bool(i % 2))))
        elif kind == 2:
            frames.append(shortframe.make_df11(icao))
        elif kind == 3:
            frames.append(shortframe.make_df4(icao, 100 * int(rng.integers(10, 400))))
        else:
            frames.append(shortframe.make_df5(icao, int(rng.integers(0, 0o7777))))
    return synth.modulate(frames, list(map(int, offsets)), SAMPLES, noise_std=60.0, seed=11)


def one(tree: str) -> dict:
    sys.path.insert(0, tree)
    import torch

    import airjax_torch
    from airjax_torch.kernels import fields, shard_gather
    from airjax_torch.parallel.mesh import Mesh
    from airjax_torch.runner import run_stream_sharded
    from airjax_torch.track.batch import BatchTracker, ExtendedBatchTracker

    iq = capture()
    mesh = Mesh([torch.device("cuda")] * 4)
    out = {"tree": tree, "package": airjax_torch.__file__, "msps": {}, "launches": {}}
    for name, make, kw in (("BatchTracker", BatchTracker, {}), ("BatchTracker --recover2", BatchTracker,
                                                                 {"recover2": True}),
                           ("ExtendedBatchTracker", ExtendedBatchTracker, {"extended": True})):
        def run():
            blocks = (iq[i : i + BLOCK] for i in range(0, SAMPLES, BLOCK))
            t0 = time.perf_counter()
            run_stream_sharded(blocks, make(), mesh=mesh, **kw)
            torch.cuda.synchronize()
            return SAMPLES / (time.perf_counter() - t0) / 1e6

        run()
        before = (shard_gather.launches, getattr(shard_gather, "fields_launches", 0), fields.launches)
        rates = [run() for _ in range(3)]
        after = (shard_gather.launches, getattr(shard_gather, "fields_launches", 0), fields.launches)
        out["msps"][name] = statistics.median(rates)
        out["launches"][name] = dict(zip(("shard_gather", "shard_gather_fields", "fields"),
                                         ((a - b) // 3 for a, b in zip(after, before))))
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
