#!/usr/bin/env python3
"""Smoke run of the airjax_torch port on one CUDA card.

  python3 chip_smoke.py

Phases; any failure raises and the exit code is nonzero:
  1. environment: a CUDA card, the torch/CUDA/nvcc versions, the card's
     name and power limit;
  2. build: nvcc compiles airjax_torch/csrc/*.cu for sm_90a into
     build/airjax_torch/ (timed);
  3. kernel against plain on the card, bit for bit: the front kernel in
     both modes and the candidate kernel, on int16 extremes, ragged
     lengths, frames with 1-bit flips in the data bits and the CRC field,
     and the full block of phase 4; each kernel timed against its plain
     version with CUDA events;
  4. one block at bench.py's shape (2^24 + 1024 samples, n_off = 2^24 - 240,
     capacity 2048, 1024 DF17 frames at multiples of 300, noise 60):
     every frame decoded, both kernels launched; kernel path and plain
     path timed (median of CUDA-event passes), then profiled
     (torch.profiler, 10 passes each): device time per kernel and per
     pass, the busy time against this run's CUDA-event pass time, and the
     front kernel's bytes moved per second;
  5. a 20 M-sample (10 s at 2 MS/s) capture with ~600 frames, some
     straddling the 20,000-sample chunk edges and some corrupted, replayed
     through the CLI (`adsb --playback FILE --fast`): overlap mode emits
     every frame once, in order; --no-overlap loses the straddlers; both
     hit lists equal the plain path's on the card.

Prints the kernel table as one JSON line, the card's name and power limit
(nvidia-smi), and last `{"ok": true, "device": {...}}`. Imports no jax.
Exits nonzero, before printing any result, without a CUDA card. Loads no
module of the JAX package `airjax` either.
"""

from __future__ import annotations

import ast
import contextlib
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

BLOCK = 1 << 24
HALO = 1024
CAPACITY = 2048
CHUNK = 20000
STREAM_SAMPLES = 20_000_000  # 10 s at 2 MS/s


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of fn() in ms, one CUDA-event pair per pass."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_abs_err(pairs) -> int:
    """Largest |kernel - plain| over tensor pairs (0 when bit-exact)."""
    err = 0
    for a, b in pairs:
        check(a.shape == b.shape and a.dtype == b.dtype, f"shape/dtype {a.shape} {b.shape}")
        if a.numel():
            err = max(err, int((a.to(torch.int64) - b.to(torch.int64)).abs().max()))
    return err


def make_frames(n: int, seed: int) -> list[bytes]:
    from airjax_torch.io import synth

    rng = np.random.default_rng(seed)
    frames = []
    for i in range(n):
        icao = int(rng.integers(1, 1 << 24))
        if i % 2:
            me = synth.make_position_me(
                11, 1000 + 25 * int(rng.integers(0, 1500)), int(rng.integers(0, 1 << 17)),
                int(rng.integers(0, 1 << 17)), bool(i % 4 == 1),
            )
        else:
            me = synth.make_id_me(f"GPU{i % 100000:05d}")
        frames.append(synth.make_df17(icao, me))
    return frames


def phase_env() -> str:
    check(torch.cuda.is_available(), "no CUDA device")
    from airjax_torch import _build

    nvcc = subprocess.run([_build.nvcc(), "--version"], capture_output=True, text=True, check=True)
    card = nvidia_smi()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    print(f"nvcc: {nvcc.stdout.strip().splitlines()[-1]}")
    print(f"card: {card}; {torch.cuda.device_count()} device(s)")
    return card


def phase_build() -> None:
    from airjax_torch import _build

    t0 = time.perf_counter()
    path = _build.build()
    _build.library()
    print(f"build: {os.path.relpath(path)} in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {' '.join(_build.NVCC_FLAGS)})")


def phase_kernels(block_dev: torch.Tensor) -> list[dict]:
    from airjax_torch.dsp.demod import compact_detections
    from airjax_torch.io import synth
    from airjax_torch.kernels.candidate import decode_candidates, decode_candidates_plain
    from airjax_torch.kernels.magdet import magdet, magdet_plain

    dev = block_dev.device
    rng = np.random.default_rng(12)

    # Front kernel: extremes + full-range random at ragged lengths, and the block.
    front_err = 0
    cases = []
    for n in (20239, 65536 + 777, (1 << 22) + 13):
        iq = rng.integers(-32768, 32768, size=(n, 2), dtype=np.int16)
        iq[:6] = [[-32768, -32768], [32767, 32767], [-32768, 32767], [0, 0], [1, 0], [3, 4]]
        cases.append(torch.as_tensor(iq).to(dev))
    cases.append(block_dev)
    for iq in cases:
        n_off = iq.shape[0] - 240
        for packed in (True, False):
            got = magdet(iq, n_off, packed=packed)
            want = magdet_plain(iq, n_off, packed=packed)
            front_err = max(front_err, max_abs_err(zip(got, want)))
    torch.cuda.synchronize()
    check(front_err == 0, f"front kernel disagrees with plain (max abs err {front_err})")
    print(f"front kernel == plain on {len(cases)} inputs, both modes")

    # Candidate kernel: frames with 1-bit flips in the data bits and in the
    # CRC field, random offsets, and the block's own candidates.
    frames = make_frames(300, 3)
    sent = list(frames)
    for i in range(0, 300, 3):
        sent[i] = synth.flip_bit(frames[i], int(rng.integers(0, 88)))
    for i in range(1, 300, 3):
        sent[i] = synth.flip_bit(frames[i], int(rng.integers(88, 112)))
    offs = np.arange(300) * 301 + 7
    iq = torch.as_tensor(synth.modulate(sent, list(offs), 300 * 301 + 500, seed=4)).to(dev)
    det, words = magdet(iq, iq.shape[0] - 240)
    o = np.concatenate([offs, rng.integers(0, iq.shape[0] - 240, 500)]).astype(np.int32)
    inputs = [(words, torch.as_tensor(o).to(dev))]
    det_b, words_b = magdet(block_dev, BLOCK - 240)
    offsets_b, valid_b, _ = compact_detections(det_b, CAPACITY)
    inputs.append((words_b, torch.where(valid_b, offsets_b, 0)))
    cand_err = 0
    for w, off in inputs:
        got = decode_candidates(w, off)
        want = decode_candidates_plain(w, off)
        cand_err = max(cand_err, max_abs_err(zip(got, want)))
        if w is words:
            f, ok, rec = (t.cpu().numpy() for t in got)
            check(bool(ok[:300][0::3].all()) and int(rec[:300].sum()) == 100,
                  "data-bit flips not all repaired")
            check(not ok[:300][1::3].any(), "a CRC-field flip validated")
            check([bytes(r) for r in f[:300][0::3]] == frames[0::3], "repaired bytes differ")
    torch.cuda.synchronize()
    check(cand_err == 0, f"candidate kernel disagrees with plain (max abs err {cand_err})")
    print(f"candidate kernel == plain on {len(inputs)} inputs")

    # Times at the main path's shapes: the 2^24-sample block, K = CAPACITY.
    n_off = BLOCK - 240
    w_b, o_b = inputs[-1]
    front_ms = cuda_ms(lambda: magdet(block_dev, n_off))
    front_plain_ms = cuda_ms(lambda: magdet_plain(block_dev, n_off))
    planes_ms = cuda_ms(lambda: magdet(block_dev, n_off, packed=False))
    planes_plain_ms = cuda_ms(lambda: magdet_plain(block_dev, n_off, packed=False))
    cand_ms = cuda_ms(lambda: decode_candidates(w_b, o_b))
    cand_plain_ms = cuda_ms(lambda: decode_candidates_plain(w_b, o_b))
    print(f"front kernel {front_ms:.4f} ms, plain {front_plain_ms:.4f} ms (2^24 samples); "
          f"candidate kernel {cand_ms:.4f} ms, plain {cand_plain_ms:.4f} ms (K={CAPACITY}); "
          f"front in mode planes {planes_ms:.4f} ms, plain {planes_plain_ms:.4f} ms")
    return [
        {"name": "magdet_front", "route": "cuda", "source": "airjax_torch/csrc/magdet.cu",
         "replaces": "airjax/kernels/magdet.py:250", "launches": None,
         "max_abs_err": front_err, "ms": front_ms, "plain_ms": front_plain_ms},
        {"name": "candidate_crc", "route": "cuda", "source": "airjax_torch/csrc/candidate.cu",
         "replaces": "airjax/dsp/demod.py:285", "launches": None,
         "max_abs_err": cand_err, "ms": cand_ms, "plain_ms": cand_plain_ms},
    ]


def phase_block(block_dev: torch.Tensor, frames: list[bytes], offsets: np.ndarray) -> None:
    from airjax_torch import pipeline
    from airjax_torch.dsp.magnitude import magnitude_u16
    from airjax_torch.kernels import candidate, magdet

    n_off = BLOCK - 240
    magdet.launches = 0
    candidate.launches = 0
    out = pipeline.to_host(pipeline.decode_iq_block(block_dev, n_off, CAPACITY))
    check(magdet.launches > 0 and candidate.launches > 0, "the block did not run both kernels")
    good = out["good"]
    check(not bool(out["overflow"]), "capacity overflow")
    check(int(out["n_good"]) == len(frames), f"n_good {int(out['n_good'])} != {len(frames)} embedded")
    check(out["offsets"][good].tolist() == offsets.tolist(), "offsets differ")
    check([bytes(r) for r in out["frames"][good]] == frames, "frame bytes differ")

    paths = {
        "kernel path": lambda: pipeline.decode_iq_block(block_dev, n_off, CAPACITY),
        "plain path": lambda: pipeline.decode_mags_block(magnitude_u16(block_dev), n_off, CAPACITY),
    }
    for name, fn in paths.items():
        ms = cuda_ms(fn, reps=15)
        print(f"block decode, {name}: {ms:.4f} ms median of 15 = "
              f"{BLOCK / ms / 1e3:.1f} MS/s, {len(frames) / ms * 1e3:.1f} msgs/s")
        profile_pass(name, fn, ms * 1e3, block_dev.shape[0], n_off)


def profile_pass(name: str, fn, pass_us: float, n_samples: int, n_off: int, passes: int = 10) -> None:
    """Where one block decode's device time goes: device time per kernel
    and the busy time per pass under torch.profiler, against the pass time
    that CUDA events measured just before without it."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(passes):
            fn()
        torch.cuda.synchronize()
    per_kernel: dict[str, float] = {}
    intervals = []
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t0, t1 = e.time_range.start, e.time_range.end
        per_kernel[e.name] = per_kernel.get(e.name, 0.0) + (t1 - t0) / passes
        intervals.append((t0, t1))
    if not intervals:
        print(f"profile, {name}: the profiler recorded no device activity (not measured)")
        return
    busy, end = 0.0, float("-inf")
    for t0, t1 in sorted(intervals):  # union of the device intervals
        busy += max(0.0, t1 - max(t0, end))
        end = max(end, t1)
    busy /= passes
    print(f"profile, {name}: {pass_us:.1f} us/pass by CUDA events, device busy "
          f"{busy:.1f} us/pass under the profiler, idle share {1 - busy / pass_us:.3f}")
    for k, us in sorted(per_kernel.items(), key=lambda kv: -kv[1])[:12]:
        print(f"  {us:9.2f} us/pass  {k[:100]}")
    front = [us for k, us in per_kernel.items() if "magdet_kernel" in k]
    if front:
        # IQ read, det written over n_off offsets, the packed compare words.
        moved = 4 * n_samples + n_off + 4 * (4 * -(-(n_samples - 1) // 128) + 8)
        print(f"  front kernel: {moved} bytes in {front[0]:.2f} us = {moved / front[0] / 1e3:.1f} GB/s")


def plain_stream_hits(iq: np.ndarray, dev: torch.device) -> list[tuple[int, bytes]]:
    """The whole-capture hit list through the plain torch path on the card
    (overlap-save slices of 2^22 offsets, independent of the CLI's 20k blocks)."""
    from airjax_torch import pipeline
    from airjax_torch.dsp.magnitude import magnitude_u16

    scan = 1 << 22
    hits = []
    n = len(iq)
    for start in range(0, n - 239, scan):
        sl = torch.as_tensor(iq[start : start + scan + 239]).to(dev)
        n_off = min(scan, sl.shape[0] - 239)
        out = pipeline.to_host(pipeline.decode_mags_block(magnitude_u16(sl), n_off, 4096))
        check(not bool(out["overflow"]), "plain stream capacity overflow")
        for k in np.nonzero(out["good"])[0]:
            hits.append((start + int(out["offsets"][k]), out["frames"][k].tobytes()))
    return hits


def run_cli(argv: list[str]) -> tuple[list[str], dict, float]:
    from airjax_torch import cli

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    wall = time.perf_counter() - t0
    check(rc == 0, f"cli {argv} returned {rc}")
    lines = buf.getvalue().splitlines()
    hexes = [ln[3:-3] for ln in lines if ln.startswith("== ") and ln.endswith(" ==")]
    stats = ast.literal_eval([ln for ln in lines if ln.startswith("stats: ")][-1][len("stats: "):])
    return hexes, stats, wall


def phase_stream(dev: torch.device) -> dict[str, int]:
    from airjax_torch.io import synth
    from airjax_torch.io.c16 import save_c16
    from airjax_torch.kernels import candidate, magdet

    rng = np.random.default_rng(20)
    n_chunks = STREAM_SAMPLES // CHUNK
    last = STREAM_SAMPLES - 10_000
    straddle = {c * CHUNK - 120 for c in rng.choice(np.arange(1, n_chunks - 1), n_chunks // 10, replace=False)}
    inside = set(rng.choice(np.arange(0, last // 300), n_chunks * 52 // 100, replace=False) * 300)
    inside = {o for o in inside if all(abs(o - s) >= 300 for s in straddle)}
    offsets = sorted(int(o) for o in straddle | inside)
    frames = make_frames(len(offsets), 21)
    corrupt = set(rng.choice(len(offsets), 12, replace=False).tolist())
    # Data bits 5..87: a flip in the DF field (bits 0-4) fails the DF17 gate,
    # so such a frame is never a candidate at all.
    sent = [synth.flip_bit(f, int(rng.integers(5, 88))) if i in corrupt else f
            for i, f in enumerate(frames)]
    # 10,000 samples past 20 M: playback drops its tail, so the 1000 full
    # chunks are all replayed.
    iq = synth.modulate(sent, offsets, STREAM_SAMPLES + 10_000, seed=22)
    print(f"stream: {len(offsets)} frames, {len(straddle)} straddling chunk edges, "
          f"{len(corrupt)} corrupted")

    plain = plain_stream_hits(iq[:STREAM_SAMPLES], dev)
    check([g for g, _ in plain] == offsets, "plain path hits differ from the embedded offsets")
    check([f for _, f in plain] == frames, "plain path frames differ from the embedded frames")

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "stream.c16")
        save_c16(iq, path)
        magdet.launches = 0
        candidate.launches = 0
        hexes, stats, wall = run_cli(["adsb", "--playback", path, "--fast"])
        launches = {"magdet_front": magdet.launches, "candidate_crc": candidate.launches}
        check(all(v > 0 for v in launches.values()), f"the stream did not run both kernels: {launches}")
        check(hexes == [f.hex() for _, f in plain], "overlap stream differs from the plain path")
        check(stats["recovered"] == len(corrupt), f"recovered {stats['recovered']} != {len(corrupt)}")
        check(stats["blocks"] == n_chunks and stats["overflow_blocks"] == 0, f"stats {stats}")
        print(f"stream overlap: {len(hexes)} frames, each once, in order; {wall:.2f} s wall, "
              f"stats {json.dumps({k: v for k, v in stats.items() if k != 'stages'})}")
        print(f"stream stages: {json.dumps(stats['stages'])}")

        hexes_p, stats_p, wall_p = run_cli(["adsb", "--playback", path, "--fast", "--no-overlap"])
        want = [f.hex() for g, f in plain if g % CHUNK < CHUNK - 240]
        check(hexes_p == want, "no-overlap stream differs from the plain path's chunk filter")
        lost = len(hexes) - len(hexes_p)
        check(lost >= len(straddle), f"no-overlap lost {lost} < {len(straddle)} straddlers")
        print(f"stream no-overlap: {len(hexes_p)} frames ({lost} lost at chunk edges); {wall_p:.2f} s wall")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs a CUDA card",
              file=sys.stderr)
        return 1
    import airjax_torch  # noqa: F401  (fails outside a checkout of the repository)
    from airjax_torch.dsp.demod import WINDOW
    from airjax_torch.io import synth

    card = phase_env()
    phase_build()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False  # the CRC product stays f32

    rng = np.random.default_rng(0)
    n_off = BLOCK - WINDOW
    offsets = np.sort(rng.choice(np.arange(0, n_off // 300) * 300, size=1024, replace=False))
    frames = make_frames(len(offsets), 1)
    t0 = time.perf_counter()
    block = synth.modulate(frames, list(map(int, offsets)), BLOCK + HALO, noise_std=60.0, seed=0)
    block_dev = torch.as_tensor(block).to(dev)
    print(f"block: {BLOCK + HALO} samples, {len(frames)} frames, made in {time.perf_counter() - t0:.2f} s")

    kernels = phase_kernels(block_dev)
    phase_block(block_dev, frames, offsets)
    launches = phase_stream(dev)
    for k in kernels:
        k["launches"] = launches[k["name"]]

    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
