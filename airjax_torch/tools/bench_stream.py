#!/usr/bin/env python3
"""Sustained streaming throughput through runner.run_stream on the card
(tools/bench_stream.py, on the port): serial (pipeline_depth=0) against
decodes kept in flight (depths 1 and 2).

Unlike airjax_torch.bench (the device pipeline, dispatch cancelled), this
measures the streaming path end to end: the source's read-ahead, the
carry stitching, the upload, the two launches a block, the fetch and the
packet assembly, which is what a deployment sustains.

  python3 airjax_torch/tools/bench_stream.py [--blocks 12] [--block-len 16777216]
      [--torch-device cuda|cpu]

The blocks are made on the card (io/synth.py::modulate_device), then copied
to numpy, as the JAX tool's. One discarded warm run on two blocks, then a
JSON line a depth: pipeline_depth, seconds, msps, good, and stage_s (the
host's seconds in each of run_stream's stages, runner.StreamStats). Exits 1 when `good`
differs between depths or from the frames embedded.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

sys.path.insert(0, str(__import__("pathlib").Path(__file__).resolve().parent.parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from airjax_torch.bench import card_label, check_device  # noqa: E402
from airjax_torch.io import synth  # noqa: E402
from airjax_torch.runner import run_stream  # noqa: E402

ICAO = 0x7C6B30


def frames_per_block(block_len: int) -> int:
    return max(1, block_len // (1 << 20))


def make_blocks(block_len: int, n_blocks: int, seed: int = 0, *, device: torch.device | str = "cuda"):
    """n_blocks distinct IQ blocks with embedded frames, made on `device`,
    as numpy arrays."""
    frame = synth.make_df17(ICAO, synth.make_id_me("STREAM"))
    blocks = []
    rng = np.random.default_rng(seed)
    n_frames = frames_per_block(block_len)
    for b in range(n_blocks):
        offsets = np.sort(rng.choice(np.arange(1, (block_len - 300) // 300) * 300, size=n_frames, replace=False))
        iq = synth.modulate_device([frame] * n_frames, list(map(int, offsets)), block_len, noise_std=60.0,
                                   seed=seed * 1000 + b, device=device)
        blocks.append(iq.cpu().numpy())
    return blocks


def run_once(blocks, depth: int, *, device: torch.device | str = "cuda") -> dict:
    """One stream over the blocks -> the JAX tool's row, and the host's
    seconds in each of run_stream's stages (runner.StreamStats)."""
    t0 = time.perf_counter()
    stats = run_stream(iter(blocks), lambda p: None, pipeline_depth=depth, device=device)
    dt = time.perf_counter() - t0
    return {"pipeline_depth": depth, "seconds": dt, "msps": stats.samples / dt / 1e6, "good": stats.good,
            "stage_s": dict(stats.stages.totals)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--blocks", type=int, default=12)
    ap.add_argument("--block-len", type=int, default=1 << 24)
    ap.add_argument("--torch-device", choices=["cuda", "cpu"], default="cuda",
                    help="cuda (default; fails without a card) or the CPU's plain versions")
    args = ap.parse_args(argv)
    device = check_device(args.torch_device)
    print(f"device: {card_label(device)}", flush=True)
    blocks = make_blocks(args.block_len, args.blocks, device=device)
    embedded = args.blocks * frames_per_block(args.block_len)
    run_once(blocks[:2], 0, device=device)  # the first run builds and uploads; discarded
    goods = set()
    for depth in (0, 1, 2):
        row = run_once(blocks, depth, device=device)
        goods.add(row["good"])
        print(json.dumps(row), flush=True)
    if goods != {embedded}:
        print(f"bench_stream: good {sorted(goods)} across depths, {embedded} frames embedded", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
