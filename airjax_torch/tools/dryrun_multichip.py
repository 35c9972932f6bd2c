#!/usr/bin/env python3
"""The multi-device dry run (__graft_entry__.py:31-190, on the port): the
sharded decodes over a mesh of N devices, each with airjax's assertions.

  python3 airjax_torch/tools/dryrun_multichip.py N [--one-card] [--torch-device cuda|cpu]

The mesh is the first N cards (parallel.mesh.make_mesh), or with
--one-card N shards of card 0 (Mesh([card 0] * N)), or with --torch-device
cpu N CPU shards. It runs:

  * the halo decode (halo.decode_capture_sharded): shards of the tuned
    block (16,384 + 784 samples), 12 frames in shard 0 against a starting
    capacity of 8 (the regrow must fire) and one frame straddling every
    shard edge; hits and stats exact;
  * the extended decode (halo.decode_capture_sharded_extended): a DF11, a
    DF4 across the shard 0/1 edge (gated by the ICAO cache), a clean DF17,
    a DF17 with one flipped bit (repaired), an interrogated DF11 and a DF24,
    from a capacity of 8; every class, the stats exact; then the same
    capture into an ExtendedBatchTracker (multihost.
    decode_capture_extended_batched) lands the same aircraft state;
  * the stream (runner.run_stream_sharded) over two full steps and a padded
    tail step, frames across source blocks, the step edge and shard edges:
    the packets of the single-device run_stream;
  * the channels (channels.decode_channels): one channel a shard, each
    finds its frame.

Prints one line `dryrun_multichip ok: ...`; any failed assertion raises
(exit 1).
"""

from __future__ import annotations

import argparse
import pathlib
import sys

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent.parent))


def _check(cond: bool, what) -> None:
    if not cond:
        raise AssertionError(what)


def dryrun_multichip(mesh) -> str:
    """The dry run over `mesh` (a parallel.mesh.Mesh) -> its summary line."""
    from airjax_torch.io import synth
    from airjax_torch.parallel import multihost
    from airjax_torch.parallel.channels import decode_channels
    from airjax_torch.parallel.halo import decode_capture_sharded, decode_capture_sharded_extended, tuned_block
    from airjax_torch.parallel.mesh import Mesh
    from airjax_torch.protocol import shortframe
    from airjax_torch.runner import run_stream, run_stream_sharded
    from airjax_torch.track.batch import ExtendedBatchTracker

    n_devices = mesh.size
    device = mesh.devices[0]
    block = tuned_block(16384)
    _check(block % 1024 == 784, block)  # the tuned decomposition
    n = block * n_devices
    frame = synth.make_df17(0x7C6B30, synth.make_id_me("DRYRUN"))

    # 12 frames inside shard 0 (more than the starting capacity of 8: the
    # regrow must fire), and one frame straddling every shard edge.
    offsets = [37 + 300 * i for i in range(12)]
    offsets += [b * block - 100 for b in range(1, n_devices)]
    iq = synth.modulate([frame] * len(offsets), offsets, n, seed=0)
    hits, stats = decode_capture_sharded(iq, mesh, capacity_per_shard=8)
    got = sorted(h[1] for h in hits)
    _check(got == sorted(offsets), f"dryrun hit mismatch: expected {sorted(offsets)}, got {got} (stats: {stats})")
    _check(all(h[2] == frame for h in hits), "frame bytes corrupted")
    _check(stats["n_good"] == len(offsets), stats)
    _check(stats["n_detections"] >= len(offsets), stats)
    _check(not stats["overflow"], stats)
    _check(stats["capacity_per_shard"] > 8, f"the overflow regrow never fired: {stats}")

    # The extended decode: a DF11 (seeds the ICAO cache), a DF4 across the
    # shard 0/1 edge (gated on that cache), a clean DF17, a DF24, a DF17
    # with one flipped bit (back through the syndrome repair), a DF11 with a
    # nonzero interrogator code (cand_df11_ic); capacity 8, so that the
    # extended regrow must fire.
    df11 = shortframe.make_df11(0x7C6B30, capability=5)
    df11_ic = shortframe.make_df11(0x7C6B30, capability=5, interrogator=7)
    df4 = shortframe.make_df4(0x7C6B30, altitude_ft=12000)
    df24 = shortframe.make_df24(0x7C6B30, nd=2, md=bytes(range(10)), ke=1)
    corrupt = bytearray(frame)
    corrupt[6] ^= 0x10
    ext_frames = [df11, df4, frame, df24, bytes(corrupt), df11_ic]
    ext_offsets = [200, block - 60 if n_devices > 1 else 900, 2000, 3200, 4400, 5600]
    ext_iq = synth.modulate(ext_frames, ext_offsets, n, seed=1)
    pkts, ext_stats = decode_capture_sharded_extended(ext_iq, mesh, capacity_per_shard=8, compact_capacity=8,
                                                      now=100.0)
    kinds = {type(p).__name__ for _, p in pkts}
    _check(kinds == {"AllCallReply", "SurveillanceReply", "AdsbPacket", "CommDReply"},
           f"extended dryrun kinds {kinds} (stats: {ext_stats})")
    _check([o for o, _ in pkts] == sorted(ext_offsets), (pkts, ext_stats))
    # Two CRC-valid long frames (one through the 1-bit repair) and one
    # zero-PI DF11; the interrogated DF11 and the AP frames are candidates.
    _check(ext_stats["n_good_long"] == 2 and ext_stats["n_good_df11"] == 1, ext_stats)
    _check(ext_stats["capacity_per_shard"] > 8, f"the extended regrow never fired: {ext_stats}")
    by_off = dict(pkts)
    _check(getattr(by_off[ext_offsets[4]], "recovered", None) is True or by_off[ext_offsets[4]].packet == frame,
           "the corrupted DF17 did not come back through the CRC repair")
    _check(type(by_off[ext_offsets[5]]).__name__ == "AllCallReply", "the DF11-IC candidate is missing")

    # The batched tracker from the gathered candidates: the same state
    # without any packet objects.
    tracker = ExtendedBatchTracker()
    applied, _ = multihost.decode_capture_extended_batched(ext_iq, tracker, mesh=mesh, now=100.0)
    _check(applied == len(pkts), (applied, len(pkts)))
    _check(tracker.aircrafts[0x7C6B30].altitude == 12000, tracker.aircrafts[0x7C6B30].altitude)
    _check(tracker.aircrafts[0x7C6B30].commd_segments == {"2": bytes(range(10)).hex()},
           tracker.aircrafts[0x7C6B30].commd_segments)

    # The sharded stream: frames across source blocks, the step edge and
    # shard edges give the single-device runner's packets.
    F = block * n_devices - 239  # fresh samples a step
    n_total = 2 * F + 40_000  # two full steps and a padded tail step
    s_offsets = [500, 20_000 - 90, block - 100, F - 130, 2 * F - 70, n_total - 245]
    s_iq = np.asarray(synth.modulate([frame] * len(s_offsets), s_offsets, n_total, seed=2))

    def blocks():
        for i in range(0, n_total, 20_000):
            yield s_iq[i : i + 20_000]

    got_single, got_sharded = [], []
    st1 = run_stream(blocks(), got_single.append, overlap=True, device=device)
    st2 = run_stream_sharded(blocks(), got_sharded.append, mesh=mesh, shard_block=block)
    _check([p.packet.hex() for p in got_single] == [p.packet.hex() for p in got_sharded],
           (len(got_single), len(got_sharded)))
    _check(st1.good == st2.good == len(s_offsets), (st1.good, st2.good))

    # The channels: one a shard.
    chan = np.stack([synth.modulate([frame], [50], 640, seed=c) for c in range(n_devices)])
    per_channel = decode_channels(chan, Mesh(mesh.devices, axis="c"), capacity=16)
    _check(all(any(h[1] == 50 and h[2] == frame for h in hits_c) for hits_c in per_channel),
           "the channel dryrun lost frames")

    return (f"dryrun_multichip ok: {n_devices} shards on {sorted({str(d) for d in mesh.devices})}, block={block}, "
            f"halo hits={len(hits)} (regrown capacity={stats['capacity_per_shard']}), extended pkts={len(pkts)} "
            f"kinds={sorted(kinds)} (regrown ext capacity={ext_stats['capacity_per_shard']}, n_candidates="
            f"{ext_stats.get('n_candidates')}), stream hits={st2.good}, channel hits="
            f"{sum(len(h) for h in per_channel)}, stats={stats}, ext_stats={ext_stats}")


def main(argv=None) -> int:
    from airjax_torch.parallel.mesh import Mesh, make_mesh

    p = argparse.ArgumentParser()
    p.add_argument("n", type=int, help="shards in the mesh")
    p.add_argument("--one-card", action="store_true", help="N shards of card 0 instead of the first N cards")
    p.add_argument("--torch-device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda (default; raises without a card) or N CPU shards")
    args = p.parse_args(argv)
    if args.torch_device == "cpu":
        mesh = make_mesh(args.n, device="cpu")
    elif args.one_card:
        if not torch.cuda.is_available():
            raise RuntimeError("--one-card: no CUDA card")
        mesh = Mesh([torch.device("cuda", 0)] * args.n)
    else:
        mesh = make_mesh(args.n)
    print(dryrun_multichip(mesh))
    return 0


if __name__ == "__main__":
    sys.exit(main())
