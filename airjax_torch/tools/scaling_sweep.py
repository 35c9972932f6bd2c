#!/usr/bin/env python3
"""Weak scaling of the halo-sharded decode (tools/scaling_sweep.py, on the
port), with the time of each stage.

The same per-device workload on D = 1, 2, 4, 8 and 16 shards, up to the
mesh's size (the work grows with D), through both gathers of
parallel/halo.py: `compact` (build_sharded_decoder_compact: one
shard-gather launch, ~n_good rows fetched) and `dense`
(build_sharded_decoder: every shard's D*K slots fetched). Stages:

  upload  host numpy -> each shard's slice on its device (halo.shard_iq),
          the devices synchronized
  step    the shards' fronts and block decodes (and the gather) until the
          scalar stats are on the host
  fetch   the candidate rows to the host
  walk    the host's hit list

  python3 airjax_torch/tools/scaling_sweep.py [--per-device 1000000]
      [--frames-per-device 8] [--repeats 3] [--json OUT]
      [--one-card | --torch-device cpu]

The mesh is the cards there are (parallel.mesh.make_mesh), or with
--one-card D shards of card 0 (Mesh([card 0] * D)), or with --torch-device
cpu D CPU shards; D stops at the cards there are, or at 8 with
--one-card or on the CPU (the JAX tool's virtual mesh). Shards that share
a device run one after another: those rows claim no efficiency
(weak_scaling_efficiency null), and a card's say "one_card": true.
Prints a JSON row a (D, gather), writes them all to OUT with --json;
exits 1 when a repeat of a row decodes other frames than those embedded.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, str(__import__("pathlib").Path(__file__).resolve().parent.parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from airjax_torch.bench import check_device  # noqa: E402
from airjax_torch.io import synth  # noqa: E402
from airjax_torch.parallel import halo  # noqa: E402
from airjax_torch.parallel.mesh import Mesh, make_mesh  # noqa: E402
from airjax_torch.pipeline import pad_iq_non_detecting, to_host  # noqa: E402


def _sync(mesh: Mesh) -> None:
    for device in set(mesh.devices):
        if device.type == "cuda":
            torch.cuda.synchronize(device)


def run_gather(mesh: Mesh, arr: np.ndarray, n: int, gather: str, repeats: int) -> tuple[dict, list[list]]:
    """`repeats` timed decodes of arr (padded to D tuned blocks) through
    `gather` -> (the stage seconds of the fastest, each repeat's hits)."""
    n_dev = mesh.size
    block = arr.shape[0] // n_dev
    K = 256
    scalars = ("n_detections", "overflow") + (("n_good",) if gather == "compact" else ())
    if gather == "compact":
        step = halo.build_sharded_decoder_compact(mesh, arr.shape[0], K, 256)
    else:
        step = halo.build_sharded_decoder(mesh, arr.shape[0], K)
    max_offset = n - halo.WINDOW

    def shard() -> list[torch.Tensor]:
        return halo.shard_iq(arr, mesh, block, halo._halo_size(block))

    to_host(step(shard()))  # warm: the build, the uploads of constants
    best, stage, every = None, None, []
    for _ in range(repeats):
        t0 = time.perf_counter()
        iq_dev = shard()
        _sync(mesh)
        t1 = time.perf_counter()
        out = step(iq_dev)
        scal = to_host({k: out[k] for k in scalars})
        t2 = time.perf_counter()
        if bool(scal["overflow"]):
            raise RuntimeError(f"{gather} step overflowed at D={n_dev}")
        if gather == "compact":
            n_good = int(scal["n_good"])
            rows = to_host({k: out[k][:n_good] for k in ("offsets", "recovered", "frames")})
        else:
            rows = to_host({k: out[k] for k in ("offsets", "good", "recovered", "frames")})
        t3 = time.perf_counter()
        hits = []
        picked = range(n_good) if gather == "compact" else np.nonzero(rows["good"])[0]
        for k in picked:
            off = int(rows["offsets"][k])
            if off <= max_offset:
                hits.append((off, rows["frames"][k].tobytes()))
        if gather == "dense":
            hits.sort()
        every.append(hits)
        t4 = time.perf_counter()
        if best is None or t4 - t0 < best:
            best = t4 - t0
            stage = {"upload": t1 - t0, "step": t2 - t1, "fetch": t3 - t2, "walk": t4 - t3}
    return stage, every


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--per-device", type=int, default=1_000_000)
    ap.add_argument("--frames-per-device", type=int, default=8)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--json", default=None, metavar="OUT")
    ap.add_argument("--one-card", action="store_true", help="D shards of card 0 instead of D cards")
    ap.add_argument("--torch-device", choices=["cuda", "cpu"], default="cuda",
                    help="cuda (default; fails without a card) or D CPU shards")
    args = ap.parse_args(argv)
    cpu = check_device(args.torch_device).type == "cpu"
    shared = cpu or args.one_card  # the shards share one device and run in sequence
    max_dev = 8 if shared else torch.cuda.device_count()
    sizes = [d for d in (1, 2, 4, 8, 16) if d <= max_dev]

    frame = synth.make_df17(0x7C6B30, synth.make_id_me("SCALE"))
    rows, base_rate, wrong = [], {}, []
    for n_dev in sizes:
        if cpu:
            mesh = make_mesh(n_dev, device="cpu")
        elif args.one_card:
            mesh = Mesh([torch.device("cuda", 0)] * n_dev)
        else:
            mesh = make_mesh(n_dev)
        n = args.per_device * n_dev
        n_frames = args.frames_per_device * n_dev
        rng = np.random.default_rng(n_dev)
        offsets = np.sort(rng.choice(np.arange(1, (n - 300) // 300) * 300, size=n_frames, replace=False))
        iq = synth.modulate_device([frame] * n_frames, list(map(int, offsets)), n, noise_std=40.0, seed=n_dev,
                                   device=mesh.devices[0]).cpu().numpy()
        block = halo.tuned_block(-(-n // n_dev))
        arr = pad_iq_non_detecting(iq, block * n_dev)
        for gather in ("compact", "dense"):
            stage, every = run_gather(mesh, arr, n, gather, args.repeats)
            rate = n / sum(stage.values()) / 1e6
            base_rate.setdefault(gather, rate)
            row = {
                "devices": n_dev,
                "gather": gather,
                "samples": n,
                "frames_embedded": n_frames,
                "frames_decoded": len(every[-1]),
                "msps": rate,
                # Flat per-device rate = 1.0; not claimed where the shards
                # share one device and so run one after another.
                "weak_scaling_efficiency": None if shared else rate / n_dev / base_rate[gather],
                "per_sample_step_ns": stage["step"] / n * 1e9,
                "host_cores": len(os.sched_getaffinity(0)),
                "stage_ms": {k: v * 1e3 for k, v in stage.items()},
                "one_card": bool(args.one_card and not cpu),
            }
            rows.append(row)
            print(json.dumps(row), flush=True)
            # Every repeat decodes every embedded frame, at its offset.
            for hits in every:
                if sorted(h[0] for h in hits) != offsets.tolist():
                    wrong.append((n_dev, gather, len(hits), n_frames))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)
    if wrong:
        print(f"scaling_sweep: rows decoded other frames than embedded (D, gather, decoded, embedded): {wrong}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
