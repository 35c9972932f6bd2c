#!/usr/bin/env python3
"""Host keep-up (tools/bench_host.py, on the port): can the host's tracker
sustain the decode's message rate? Two sinks over one message stream:

  per packet  AdsbPacket.from_bytes + handle_aircraft_update a frame (what
              run_stream's default sink does)
  batched     BatchTracker.on_fields a block of BLOCK frames (what
              run_stream hands a sink that has on_fields; the fields come
              from the decode's own launch in production, so they are
              extracted before the clock starts and only the host's work
              is timed)

The stream is the tracker's worst case: every position message makes a
CPR pair (alternating parity), so pairing and the geodecode run at full
rate. The extended half decodes one block of every batched class (IDs,
position pairs, velocities, DF11 all-calls, cache-gated DF4) through
pipeline.decode_iq_block_extended_with_fields on --torch-device (the
front, then the block decode with its flag F), then applies it over and
over through assemble_extended + handle_extended_update a packet against
ExtendedBatchTracker.on_extended_block. Both sinks must land the same
aircraft and the same geo fixes, or it fails.

  python3 airjax_torch/tools/bench_host.py [--messages 200000] [--torch-device cuda|cpu]

Prints one JSON line: messages, per_packet_msgs_per_s, batched_msgs_per_s,
speedup, aircraft, with_geo, and the same with an `extended_` prefix.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

sys.path.insert(0, str(__import__("pathlib").Path(__file__).resolve().parent.parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from airjax_torch.bench import check_device  # noqa: E402
from airjax_torch.io import synth  # noqa: E402
from airjax_torch.protocol.fields import extract_fields  # noqa: E402
from airjax_torch.protocol.packet import AdsbPacket  # noqa: E402
from airjax_torch.track.aircraft import handle_aircraft_update  # noqa: E402
from airjax_torch.track.batch import BatchTracker  # noqa: E402

BLOCK = 1024  # good frames per decode block at bench density


def _check(cond: bool, what) -> None:
    if not cond:
        raise AssertionError(what)


def build_stream(n_messages: int, n_aircraft: int = 64) -> np.ndarray:
    """(n_messages, 14) uint8: a cycle over the aircraft's ID, even and odd
    position frames."""
    frames = []
    for a in range(n_aircraft):
        icao = 0x100000 + a
        frames.append(synth.make_df17(icao, synth.make_id_me(f"AC{a:05d}")))
        for cpr_lat, cpr_lon, odd in ((93000, 51372, False), (74158, 50194, True)):
            frames.append(synth.make_df17(icao, synth.make_position_me(
                tc=11, altitude_ft=10000 + a * 25, cpr_lat=cpr_lat, cpr_lon=cpr_lon, odd=odd)))
    seq = [frames[i % len(frames)] for i in range(n_messages)]
    return np.frombuffer(b"".join(seq), np.uint8).reshape(n_messages, 14)


def build_extended_block(n_aircraft: int = 64, repeats: int = 3, *, device: torch.device | str = "cuda"):
    """One extended decode block: a aircraft and a repeat, an ID, an even and
    an odd position and a TC19 velocity, and DF11 and DF4 for half the
    fleet (~960 messages, the device's block at bench density) -> (the
    host dict of decode_iq_block_extended_with_fields on `device`, the
    frames embedded)."""
    from airjax_torch.pipeline import decode_iq_block_extended_with_fields, to_host
    from airjax_torch.protocol import shortframe

    frames = []
    for r in range(repeats):
        for a in range(n_aircraft):
            icao = 0x100000 + a
            frames.append(synth.make_df17(icao, synth.make_id_me(f"AC{a:05d}")))
            for cpr_lat, cpr_lon, odd in ((93000 + r, 51372, False), (74158 + r, 50194, True)):
                frames.append(synth.make_df17(icao, synth.make_position_me(
                    tc=11, altitude_ft=10000 + a * 25 + r, cpr_lat=cpr_lat, cpr_lon=cpr_lon, odd=odd)))
            frames.append(synth.make_df17(icao, synth.make_velocity_me(
                ew_kt=100 + a, ns_kt=-50, vertical_rate_fpm=640)))
            if a % 2 == 0:
                frames.append(shortframe.make_df11(icao))
                frames.append(shortframe.make_df4(icao, 10000 + a * 25))
    spacing = 400
    n = ((len(frames) * spacing + 2048) // 1024) * 1024
    iq = synth.modulate(frames, [100 + i * spacing for i in range(len(frames))], n, seed=3)
    out = to_host(decode_iq_block_extended_with_fields(torch.as_tensor(iq).to(device), n - 240, 4096))
    n_good = int(np.sum(out["good_long"] | out["good_df11"]))
    _check(n_good >= len(frames) - n_aircraft * repeats, (n_good, len(frames)))
    return out, len(frames)


def run_extended(M: int, *, device: torch.device | str = "cuda") -> dict:
    """Extended keep-up: assemble_extended + handle_extended_update a
    packet against ExtendedBatchTracker.on_extended_block a block, over the
    same decoded block applied M // its frames times."""
    from airjax_torch.extended import assemble_extended, handle_extended_update
    from airjax_torch.track.batch import ExtendedBatchTracker
    from airjax_torch.track.icao_cache import IcaoCache

    out, per_block = build_extended_block(device=device)
    n_blocks = max(M // per_block, 1)

    aircrafts = {}
    cache = IcaoCache()
    t0 = time.perf_counter()
    t = 1000.0
    n_pkt = 0
    for _ in range(n_blocks):
        for _off, pkt in assemble_extended(out, t, cache):
            handle_extended_update(pkt, aircrafts)
            n_pkt += 1
        t += 0.5
    dt_pkt = time.perf_counter() - t0

    bt = ExtendedBatchTracker()
    cache_b = IcaoCache()
    t0 = time.perf_counter()
    t = 1000.0
    n_bat = 0
    for _ in range(n_blocks):
        n_bat += bt.on_extended_block(out, t, cache_b)
        t += 0.5
    dt_bat = time.perf_counter() - t0

    _check(n_pkt == n_bat and len(aircrafts) == len(bt.aircrafts), (n_pkt, n_bat, len(aircrafts), len(bt.aircrafts)))
    geo_pkt = sum(1 for a in aircrafts.values() if a.geo_position)
    geo_bat = sum(1 for a in bt.aircrafts.values() if a.geo_position)
    _check(geo_pkt == geo_bat, (geo_pkt, geo_bat))
    return {
        "extended_messages": n_pkt,
        "extended_per_packet_msgs_per_s": n_pkt / dt_pkt,
        "extended_batched_msgs_per_s": n_bat / dt_bat,
        "extended_speedup": dt_pkt / dt_bat,
        "extended_aircraft": len(aircrafts),
        "extended_with_geo": geo_pkt,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--messages", type=int, default=200_000)
    ap.add_argument("--torch-device", choices=["cuda", "cpu"], default="cuda",
                    help="where the extended block is decoded: cuda (default; fails without a card) or the CPU")
    args = ap.parse_args(argv)
    device = check_device(args.torch_device)
    M = args.messages

    arr = build_stream(M)
    frame_bytes = [arr[i].tobytes() for i in range(M)]

    aircrafts = {}
    t0 = time.perf_counter()
    for i in range(M):
        handle_aircraft_update(AdsbPacket.from_bytes(frame_bytes[i], 1000.0), aircrafts)
    dt_pkt = time.perf_counter() - t0
    geo_pkt = sum(1 for a in aircrafts.values() if a.geo_position)

    # The fields of each block before the clock starts (the decode's own
    # launch in production): only on_fields' host work is timed.
    blocks = []
    for i in range(0, M, BLOCK):
        sub = arr[i : i + BLOCK]
        fields = {k: v.numpy() for k, v in extract_fields(torch.tensor(sub)).items()}
        blocks.append((fields, np.arange(len(sub))))
    bt = BatchTracker()
    t0 = time.perf_counter()
    for fields, idx in blocks:
        bt.on_fields(fields, idx, 1000.0)
    dt_bat = time.perf_counter() - t0
    geo_bat = sum(1 for a in bt.aircrafts.values() if a.geo_position)

    _check(geo_pkt == geo_bat and len(aircrafts) == len(bt.aircrafts),
           (geo_pkt, geo_bat, len(aircrafts), len(bt.aircrafts)))
    out = {
        "messages": M,
        "per_packet_msgs_per_s": M / dt_pkt,
        "batched_msgs_per_s": M / dt_bat,
        "speedup": dt_pkt / dt_bat,
        "aircraft": len(aircrafts),
        "with_geo": geo_pkt,
    }
    out.update(run_extended(M, device=device))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
