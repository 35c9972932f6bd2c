"""The port's benchmark (bench.py on the port): sustained IQ decode
throughput of one block on one card.

  python3 -m airjax_torch.bench [--trace [DIR]] [--torch-device cuda|cpu]

Prints ONE JSON line with bench.py's keys:
  {"metric": "iq_throughput_msps", "value": N, "unit": "Msamples/s",
   "vs_baseline": N / 2.0, "detail": {...}}

vs_baseline is the speedup over the reference's design floor of 2.0 MS/s
(bench.py, BASELINE.md). `detail` has every key of bench.py's, `device`
being the card's name, plus `power_limit_w` (nvidia-smi) and
`eager_seconds_per_pass`.

The workload is bench.py's (build_workload): 1 DF17 frame per 16,384
samples on the 300-sample grid, noise 60, built on the device by
io/synth.py::modulate_device. A pass is pipeline.decode_iq_block over
n_off = block_len - WINDOW offsets: the front kernel, then the block-decode
kernel, the two launches of `adsb`'s decode and the port's counterpart of
airjax's decode_mags_block(magnitude_u16(iq)).

Measurement on a card. bench.py runs R passes inside one jitted
fori_loop and takes the slope between two R, which cancels the fixed
dispatch. The port's counterpart is one CUDA graph holding R passes, one
dispatch for R passes: after one eager warm-up pass (it builds the
library and uploads the __constant__ syndromes, which a capture cannot),
a graph of r_small passes and one of r_big are captured, each replay is
timed between two CUDA events (best of 3, as bench.py's _timed), and
seconds_per_pass is the slope. Every pass adds its n_good and
n_detections into two int64 device scalars, read once after the
replays. The same r_big passes launched from Python without a graph give
`eager_seconds_per_pass`: what `adsb` pays, host launch path included.
All passes run on one stream, since the block-decode kernel's n_good
accumulator is per device.

No per-pass perturbation: bench.py adds the pass index to the IQ only so
that XLA cannot hoist the loop-invariant decode out of its loop. CUDA runs
every kernel it is given, and on the port the add would be a kernel of
its own in every pass (64 MB in, 64 MB out), about as long as the front.

On the CPU (device="cpu", for the tests) there are no graphs: the passes
run eagerly through the kernels' plain versions, and seconds_per_pass is
the median time of one pass (a slope between two host timings can come
out negative under a loaded host); fixed_overhead_s is 0 there.

Without a card, and without --torch-device cpu, it fails: it never falls
back to the CPU. On any failure it prints bench.py's error line, then
raises (the exit code is nonzero).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from airjax_torch.dsp.demod import WINDOW
from airjax_torch.io import synth
from airjax_torch.pipeline import decode_iq_block

HALO = 1024  # bench.py's halo: >= WINDOW - 1, the block a multiple of 1024


def build_workload(block_len: int, n_blocks: int, seed: int = 0, *, device: torch.device | str = "cuda"):
    """bench.py's synthetic capture on `device` -> (blocks, frames embedded):
    n_blocks views of one (block_len * n_blocks + HALO, 2) int16 tensor,
    block i its samples [i * block_len, (i + 1) * block_len + HALO)."""
    n = block_len * n_blocks + HALO
    rng = np.random.default_rng(seed)
    frame = synth.make_df17(0x7C6B30, synth.make_id_me("BENCH00"))
    n_frames = max(1, n // 16384)  # ~1 frame per 16k samples (dense traffic)
    offsets = np.sort(rng.choice(np.arange(0, (n - WINDOW) // 300) * 300, size=n_frames, replace=False))
    iq = synth.modulate_device([frame] * len(offsets), list(map(int, offsets)), n, noise_std=60.0, seed=seed,
                               device=device)
    blocks = tuple(iq[i * block_len : (i + 1) * block_len + HALO] for i in range(n_blocks))
    return blocks, len(offsets)


def df17_body(iq: torch.Tensor, n_off: int, capacity: int) -> tuple[torch.Tensor, torch.Tensor]:
    """One pass of bench.py: decode_iq_block -> (n_good, n_detections)."""
    out = decode_iq_block(iq, n_off, capacity)
    return out["n_good"], out["n_detections"]


def make_repeat_step(block_len: int, capacity: int, body=df17_body):
    """step(blocks, reps, acc): `reps` passes of body(block, block_len -
    WINDOW, capacity), pass r on blocks[r % len(blocks)], each adding its
    two counts into acc ((2,) int64 on the blocks' device); returns acc.
    The first pass sets acc rather than adding to it, so that a graph of
    the passes starts from 0 at every replay without a kernel of its own."""
    n_off = block_len - WINDOW

    def step(blocks, reps: int, acc: torch.Tensor) -> torch.Tensor:
        for r in range(reps):
            counts = body(blocks[r % len(blocks)], n_off, capacity)
            for total, count in zip(acc, counts):
                (total.add_ if r else total.copy_)(count)
        return acc

    return step


def _timed(fn, *args, iters: int = 3) -> tuple[float, tuple[int, ...]]:
    """Best of `iters` calls of fn(*args), each timed between two CUDA
    events on the current stream -> (the best seconds, the device tensor
    that the last call returned, fetched as ints after it)."""
    best = float("inf")
    out = None
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args)
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / 1e3)
    return best, tuple(int(x) for x in out.tolist())


def capture(step, blocks, reps: int, acc: torch.Tensor) -> torch.cuda.CUDAGraph:
    """A CUDA graph of step(blocks, reps, acc): one replay runs the reps
    passes' launches, nothing else. The library must be built and the
    constants uploaded (one eager pass) first."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        step(blocks, reps, acc)
    return graph


def measure(step, blocks, r_small: int, r_big: int) -> dict:
    """Time step's passes on the blocks' device -> seconds_per_pass,
    fixed_overhead_s, eager_seconds_per_pass, and `sums`, the two counts
    summed over r_big passes (the module docstring says how)."""
    if r_big <= r_small or r_small < 1:
        raise ValueError(f"need 1 <= r_small < r_big, got {r_small}, {r_big}")
    device = blocks[0].device
    acc = torch.zeros(2, dtype=torch.int64, device=device)
    if device.type == "cpu":
        times = []
        sums = np.zeros(2, dtype=np.int64)
        for r in range(r_big):
            t0 = time.perf_counter()
            step((blocks[r % len(blocks)],), 1, acc)
            sums += acc.numpy()
            times.append(time.perf_counter() - t0)
        per_pass = statistics.median(times)
        return {"seconds_per_pass": per_pass, "fixed_overhead_s": 0.0, "eager_seconds_per_pass": per_pass,
                "sums": tuple(int(s) for s in sums)}
    with torch.cuda.device(device):
        step(blocks, 1, acc)  # the warm-up pass: the build and the uploads
        torch.cuda.synchronize()
        graphs = {r: capture(step, blocks, r, acc) for r in (r_small, r_big)}

        def replay(reps: int) -> torch.Tensor:
            graphs[reps].replay()
            return acc

        t_small, _ = _timed(replay, r_small)
        t_big, sums = _timed(replay, r_big)
        del graphs  # their pools (r_big passes' outputs) before the eager passes
        t_eager, eager_sums = _timed(step, blocks, r_big, acc)
    if eager_sums != sums:
        raise RuntimeError(f"the graph's sums {sums} differ from the eager passes' {eager_sums}")
    per_pass = (t_big - t_small) / (r_big - r_small)
    return {"seconds_per_pass": per_pass, "fixed_overhead_s": t_small - per_pass * r_small,
            "eager_seconds_per_pass": t_eager / r_big, "sums": sums}


def check_device(device: torch.device | str) -> torch.device:
    """`device` as a torch.device; raises for a card when there is none
    (the harness never falls back to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card (torch.cuda.is_available() is false); --torch-device cpu runs the "
                           "kernels' plain versions")
    return device


def card(device: torch.device) -> tuple[str, float | None]:
    """(the device's name, its power limit in W from nvidia-smi; None on the CPU)."""
    if device.type == "cpu":
        return "cpu", None
    index = device.index if device.index is not None else torch.cuda.current_device()
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits", "-i", str(index)],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return torch.cuda.get_device_name(index), float(out.stdout.strip())


def card_label(device: torch.device) -> str:
    """card() as text: "<name>, <limit> W", or "cpu"."""
    name, power_limit = card(device)
    return name if power_limit is None else f"{name}, {power_limit} W"


def bench(block_len=1 << 24, n_blocks=1, capacity=2048, r_small=2, r_big=42, *, device="cuda") -> dict:
    """bench.py's measurement on `device` -> its result dict (the JSON line)."""
    device = check_device(device)
    blocks, n_frames = build_workload(block_len, n_blocks, device=device)
    total_samples = block_len - WINDOW  # offsets scanned per pass (n_off)
    timing = measure(make_repeat_step(block_len, capacity), blocks, r_small, r_big)
    per_pass = timing["seconds_per_pass"]
    good_sum, det_sum = timing["sums"]
    n_good, n_det = good_sum // r_big, det_sum // r_big
    name, power_limit = card(device)
    msps = total_samples / per_pass / 1e6
    # Unrounded, unlike bench.py's: its microseconds would keep two digits of
    # a pass of tens of microseconds, and a CPU run's MS/s can round to 0.
    return {
        "metric": "iq_throughput_msps",
        "value": msps,
        "unit": "Msamples/s",
        "vs_baseline": msps / 2.0,
        "detail": {
            "device": name,
            "power_limit_w": power_limit,
            "block_len": block_len,
            "n_blocks": n_blocks,
            "seconds_per_pass": per_pass,
            "fixed_overhead_s": timing["fixed_overhead_s"],
            "eager_seconds_per_pass": timing["eager_seconds_per_pass"],
            "frames_embedded": n_frames,
            "frames_decoded_per_pass": n_good,
            "detections_per_pass": n_det,
            "decoded_msgs_per_s": n_good / per_pass,
            "effective_gbps": total_samples * 4 / per_pass / 1e9,
        },
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--trace", nargs="?", const=os.path.join(tempfile.gettempdir(), "airjax_torch_bench_trace"),
                   default=None, metavar="DIR", help="a torch.profiler trace of the run into DIR")
    p.add_argument("--torch-device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda (default; fails without a card) or the CPU's plain versions")
    p.add_argument("--block-len", type=int, default=1 << 24)
    p.add_argument("--n-blocks", type=int, default=1)
    p.add_argument("--capacity", type=int, default=2048)
    p.add_argument("--r-small", type=int, default=2)
    p.add_argument("--r-big", type=int, default=42)
    args = p.parse_args(argv)
    ctx = contextlib.nullcontext()
    if args.trace:
        from airjax_torch.observability import trace

        ctx = trace(args.trace)  # status through logging: the JSON line stays alone on stdout
    try:
        with ctx:
            result = bench(args.block_len, args.n_blocks, args.capacity, args.r_small, args.r_big,
                           device=args.torch_device)
        print(json.dumps(result))
    except Exception as e:  # always emit the contract line, then fail
        print(json.dumps({"metric": "iq_throughput_msps", "value": 0, "unit": "Msamples/s", "vs_baseline": 0,
                          "error": f"{type(e).__name__}: {e}"[:300]}))
        raise
    return 0


if __name__ == "__main__":
    sys.exit(main())
