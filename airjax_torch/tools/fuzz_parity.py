#!/usr/bin/env python3
"""Differential parity fuzzer (tools/fuzz_parity.py, on the port): the
port's decode_capture_parity against its golden scalar decoder on random
captures — lengths at and around the chunk edges, SNRs, overlapping and
corrupted frames, tie-heavy low-amplitude streams, constant-magnitude
storms; airjax's capture kinds and lengths, drawn in airjax's order.

  python3 airjax_torch/tools/fuzz_parity.py [--iters 200] [--seed 0] [--chunk 4000]
      [--torch-device cuda|cpu]

Any mismatch is a bit-exactness fault: the capture is saved to
build/airjax_torch/fuzz_parity_mismatch.npy and the exit code is 1. Exit
0: every iteration agreed.
"""

from __future__ import annotations

import argparse
import pathlib
import sys

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent.parent.parent
sys.path.insert(0, str(REPO))

from airjax_torch import golden  # noqa: E402
from airjax_torch.config import PipelineConfig  # noqa: E402
from airjax_torch.io import synth  # noqa: E402
from airjax_torch.pipeline import decode_capture_parity  # noqa: E402


def random_capture(rng: np.random.Generator, chunk: int) -> np.ndarray:
    """One capture of airjax's six kinds (tools/fuzz_parity.py:27-87)."""
    kind = rng.integers(0, 6)
    n = int(rng.choice([chunk - 1, chunk, chunk + 1, 2 * chunk, 2 * chunk + 1, int(rng.integers(300, 3 * chunk))]))
    if kind == 0:  # pure noise
        return np.clip(np.round(rng.normal(0, rng.uniform(5, 500), (n, 2))), -32768, 32767).astype(np.int16)
    if kind == 1:  # tiny amplitudes: a truncation-tie storm
        return rng.integers(-4, 5, size=(n, 2)).astype(np.int16)
    if kind == 2:  # constant stream: every offset detects
        return np.full((n, 2), int(rng.integers(0, 50)), dtype=np.int16)
    # Frames at random (possibly overlapping) offsets, random SNR and corruption.
    n = max(n, 1200)
    frames, offsets = [], []
    for _ in range(int(rng.integers(1, 6))):
        icao = int(rng.integers(0, 1 << 24))
        if rng.random() < 0.5:
            me = synth.make_id_me("FZ" + str(rng.integers(100, 999)))
        else:
            me = synth.make_position_me(
                tc=int(rng.integers(9, 19)), altitude_ft=int(rng.integers(0, 2000)) * 25 - 1000,
                cpr_lat=int(rng.integers(0, 1 << 17)), cpr_lon=int(rng.integers(0, 1 << 17)),
                odd=bool(rng.integers(0, 2)),
            )
        frame = synth.make_df17(icao, me)
        if rng.random() < 0.3:
            frame = synth.flip_bit(frame, int(rng.integers(0, 112)))
        frames.append(frame)
        offsets.append(int(rng.integers(0, n - 300)))
    snr = float(rng.uniform(0, 25)) if rng.random() < 0.7 else None
    return synth.modulate(frames, offsets, n, snr_db=snr, noise_std=float(rng.uniform(10, 200)),
                          seed=int(rng.integers(0, 1 << 31)))


def run(iters: int, seed: int, chunk: int, device: str) -> int:
    rng = np.random.default_rng(seed)
    cfg = PipelineConfig(block_len=chunk, max_candidates=128)
    for i in range(iters):
        iq = random_capture(rng, chunk)
        ours, _ = decode_capture_parity(iq, cfg, device=device)
        gold = golden.decode_capture_playback(iq, chunk=chunk)
        ours_cmp = [(c, o, f) for c, o, f, _ in ours]
        if ours_cmp != gold:
            path = REPO / "build" / "airjax_torch" / "fuzz_parity_mismatch.npy"
            path.parent.mkdir(parents=True, exist_ok=True)
            np.save(path, iq)
            print(f"MISMATCH at iteration {i} (len={len(iq)}); the capture is in {path}")
            print(" ours:", ours_cmp[:5])
            print(" gold:", gold[:5])
            return 1
        if (i + 1) % 25 == 0:
            print(f"{i + 1}/{iters} ok ({len(gold)} hits last)")
    print(f"all {iters} iterations bit-exact")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--iters", type=int, default=200)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--chunk", type=int, default=4000)
    p.add_argument("--torch-device", choices=["cuda", "cpu"], default="cuda",
                   help="where the decode runs (default cuda; raises without a card)")
    args = p.parse_args(argv)
    return run(args.iters, args.seed, args.chunk, args.torch_device)


if __name__ == "__main__":
    sys.exit(main())
