#!/usr/bin/env python3
"""Three-way extended-mode parity fuzzer (tools/fuzz_extended.py, on the
port): device == golden == native.

Random mixed-format captures (DF0/4/5/11 with interrogated all-calls, 16,
17, 18, 20, 21, 24) at random SNRs, with corrupted frames, chunk-edge
offsets, tie storms and constant-magnitude storms, airjax's kinds and
lengths drawn in airjax's order; every iteration must give the same
(offset, kind, frame bytes, icao_ap) stream from

  * the port's extended decode on the device (pipeline.decode_iq_block_extended:
    the front and the block-decode kernel on a card),
  * the golden scalar oracle (golden.decode_chunk_extended), and
  * the native C++ decoder (native.decode_chunk_extended).

  python3 airjax_torch/tools/fuzz_extended.py [--iters 320] [--seed 0] [--chunk 4000]
      [--recover2] [--torch-device cuda|cpu]

--recover2 fuzzes the 2-bit repair three ways (each tier classes a repair
as 'long2'). A mismatch saves the capture to
build/airjax_torch/fuzz_extended_mismatch.npy and exits 1; exit 0: every
iteration agreed.
"""

from __future__ import annotations

import argparse
import pathlib
import sys

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent.parent.parent
sys.path.insert(0, str(REPO))

from airjax_torch import golden, native  # noqa: E402
from airjax_torch.io import synth  # noqa: E402
from airjax_torch.protocol import shortframe  # noqa: E402


def random_frame(rng: np.random.Generator) -> bytes:
    """One frame of airjax's ten kinds (tools/fuzz_extended.py:34-79)."""
    icao = int(rng.integers(0, 1 << 24))
    kind = int(rng.integers(0, 10))
    if kind == 0:
        return synth.make_df17(icao, synth.make_id_me("X" + str(rng.integers(10, 99))))
    if kind == 1:
        return synth.make_df17(icao, synth.make_position_me(
            tc=int(rng.integers(9, 19)), altitude_ft=int(rng.integers(0, 2000)) * 25 - 1000,
            cpr_lat=int(rng.integers(0, 1 << 17)), cpr_lon=int(rng.integers(0, 1 << 17)),
            odd=bool(rng.integers(0, 2)),
        ))
    if kind == 2:
        return synth.make_df18(icao, synth.make_id_me("TISB"), cf=int(rng.integers(0, 2)))
    if kind == 3:  # all-call; half interrogated (PI ^= a nonzero IC)
        return shortframe.make_df11(icao, interrogator=int(rng.integers(0, 16)) if rng.random() < 0.5 else 0)
    alt = int(rng.integers(0, 2000)) * 25 - 1000
    squawk = int("".join(str(rng.integers(0, 8)) for _ in range(4)))
    gillham = bool(rng.random() < 0.3) and 0 <= alt <= 50000 and alt % 100 == 0
    if kind == 4:
        return shortframe.make_df0(icao, alt, vs=int(rng.integers(0, 2)), gillham=gillham)
    if kind == 5:
        return shortframe.make_df16(icao, alt, gillham=gillham)
    if kind == 6:
        return shortframe.make_df4(icao, alt, fs=int(rng.integers(0, 6)), gillham=gillham)
    if kind == 7:
        return shortframe.make_df5(icao, squawk)
    if kind == 9:  # DF24 Comm-D ELM segment
        return shortframe.make_df24(icao, nd=int(rng.integers(0, 16)),
                                    md=bytes(rng.integers(0, 256, 10, dtype=np.uint8)), ke=int(rng.integers(0, 2)))
    if rng.random() < 0.5:
        return shortframe.make_df20(icao, alt, gillham=gillham)
    return shortframe.make_df21(icao, squawk)


def random_capture(rng: np.random.Generator, chunk: int) -> np.ndarray:
    """One capture of airjax's six kinds (tools/fuzz_extended.py:82-115)."""
    kind = rng.integers(0, 6)
    n = int(rng.choice([chunk - 1, chunk, chunk + 1, 2 * chunk, chunk // 2, 700]))
    if kind == 0:  # pure noise
        return np.clip(np.round(rng.normal(0, rng.uniform(5, 500), (n, 2))), -32768, 32767).astype(np.int16)
    if kind == 1:  # tiny amplitudes: a truncation-tie storm
        return rng.integers(-4, 5, size=(n, 2)).astype(np.int16)
    if kind == 2:  # constant stream: every offset detects
        return np.full((n, 2), int(rng.integers(0, 50)), dtype=np.int16)
    n = max(n, 1200)
    frames, offsets = [], []
    for _ in range(int(rng.integers(1, 7))):
        frame = random_frame(rng)
        if rng.random() < 0.3:  # corruption: the 1-bit repair and the AP overlay
            frame = synth.flip_bit(frame, int(rng.integers(0, 8 * len(frame))))
        frames.append(frame)
        # Chunk-edge offsets too (partial frames past the scan limit).
        offsets.append(int(rng.integers(0, n - 300)) if rng.random() < 0.8 else int(n - rng.integers(240, 300)))
    snr = float(rng.uniform(0, 25)) if rng.random() < 0.7 else None
    return synth.modulate(frames, offsets, n, snr_db=snr, noise_std=float(rng.uniform(10, 200)),
                          seed=int(rng.integers(0, 1 << 31)))


def device_classified(iq: np.ndarray, device: str, recover2: bool = False) -> list[tuple[int, str, bytes, int]]:
    """The extended decode on `device` -> the oracle's (offset, kind, frame,
    icao_ap) stream (airjax's mapping, tools/fuzz_extended.py:118-163);
    recover2=True classes the 2-flip repairs as 'long2'."""
    import torch

    from airjax_torch.pipeline import decode_iq_block_extended, to_host

    n_off = len(iq) - 240
    if n_off <= 0:
        return []
    out = to_host(decode_iq_block_extended(torch.as_tensor(iq, device=device), n_off, 256, recover2))
    hits = []
    for k in range(len(out["offsets"])):
        off = int(out["offsets"][k])
        if not out["valid"][k]:
            continue
        if out["good_long"][k]:
            kind = "long2" if recover2 and out["recovered2"][k] else "long"
            hits.append((off, kind, out["frames"][k].tobytes(), 0))
        elif out["good_df11"][k]:
            hits.append((off, "df11", out["frames_raw"][k].tobytes()[:7], 0))
        elif out["cand_df11_ic"][k]:
            hits.append((off, "df11_ic", out["frames_raw"][k].tobytes()[:7], int(out["icao_ap_short"][k])))
        elif out["cand_short_ap"][k]:
            hits.append((off, "short_ap", out["frames_raw"][k].tobytes()[:7], int(out["icao_ap_short"][k])))
        elif out["cand_long_ap"][k]:
            hits.append((off, "long_ap", out["frames_raw"][k].tobytes(), int(out["icao_ap_long"][k])))
    return hits


def run(iters: int, seed: int, chunk: int, device: str, recover2: bool = False) -> int:
    rng = np.random.default_rng(seed)
    for i in range(iters):
        iq = random_capture(rng, chunk)
        gold = golden.decode_chunk_extended(iq, recover2=recover2)
        dev = device_classified(iq, device, recover2=recover2)
        nat, _ = native.decode_chunk_extended(iq, max_hits=max(4096, len(gold) + 64), recover2=recover2)
        if dev != gold or nat != gold:
            bad = "device" if dev != gold else "native"
            ours = dev if dev != gold else nat
            path = REPO / "build" / "airjax_torch" / "fuzz_extended_mismatch.npy"
            path.parent.mkdir(parents=True, exist_ok=True)
            np.save(path, iq)
            print(f"MISMATCH at iteration {i} (len={len(iq)}); the capture is in {path}")
            for a, b in zip(ours[:8], gold[:8]):
                print(f"{'  ' if a == b else '->'} {bad}: {a}\n   gold:   {b}")
            print(f"   lens: {bad}={len(ours)} gold={len(gold)}")
            return 1
        if (i + 1) % 25 == 0:
            print(f"{i + 1}/{iters} ok ({len(gold)} hits last)")
    print(f"all {iters} iterations three-way bit-exact")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--iters", type=int, default=320)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--chunk", type=int, default=4000)
    p.add_argument("--recover2", action="store_true",
                   help="fuzz the 2-bit repair three ways (every tier classes a repair as 'long2')")
    p.add_argument("--torch-device", choices=["cuda", "cpu"], default="cuda",
                   help="where the device tier runs (default cuda; raises without a card)")
    args = p.parse_args(argv)
    return run(args.iters, args.seed, args.chunk, args.torch_device, recover2=args.recover2)


if __name__ == "__main__":
    sys.exit(main())
