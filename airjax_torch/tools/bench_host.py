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

  python3 airjax_torch/tools/bench_host.py --sink [--blocks 300] [--gap-ms 0] [--torch-device cuda|cpu]

times the web map's extended batched sink instead (`adsb -m web
--extended --batched`) on a busy sky's 20,000-sample blocks, in ms a
block: the whole call, and its parts one after another (selection,
gating, walk, CPR, summaries), with decode_pairs alone. `--gap-ms`
sleeps that long before each whole call, as a live stream leaves the
host idle between blocks. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import statistics
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


# The busy sky of the web map's extended cell (adsbench/traffic/
# busy.live.json): 300 aircraft, each frame kind's rate a second an
# aircraft (squitters: ICAO Annex 10 Vol IV, DO-260B; replies as that file
# assumes), ~18 frames a 10 ms block. A copy, not that file's generator,
# and it differs from it so: every interval within +-20% (the file draws
# identification within +-4%); no frame with bit errors added (the file
# flips one data bit in 1% of DF17s and two in 1%, so recover2's repairs
# never run here); one amplitude for every frame in place of the file's
# link model (transmit power, slant range, antenna gains, line loss);
# aircraft that hold their position and a velocity of up to 400 kt on
# each axis in place of level flights at 200-250 m/s; noise at
# synth.modulate's 60 a rail, as the file's.
LIVE_AIRCRAFT = 300
LIVE_RATES = (("position", 2.0), ("velocity", 2.0), ("id", 0.2), ("df11", 1.0),
              ("df4", 0.5), ("df5", 0.2), ("df20", 0.2))
LIVE_BLOCK = 20_000  # samples a block at 2.0 MS/s
LIVE_OVERLAP = 240  # the overlap scan's tail


def build_live_blocks(n_blocks: int, *, device: torch.device | str = "cuda", seed: int = 1) -> list[dict]:
    """`n_blocks` 20,000-sample blocks of the busy sky (LIVE_RATES, each
    interval within +-20%, over 50-54 N, 2-7 E) as the overlap scan cuts
    them, each decoded with its fields on `device` at the stream's
    capacity (256 slots, regrown as run_stream regrows) -> the host dicts
    of decode_iq_block_extended_with_fields."""
    from airjax_torch.pipeline import decode_iq_block_extended_with_fields, to_host
    from airjax_torch.protocol import shortframe

    rng = np.random.default_rng(seed)
    n = n_blocks * LIVE_BLOCK + LIVE_OVERLAP
    seconds = (n - 240) / 2e6
    frames, offsets = [], []
    for a, icao in enumerate(rng.choice((1 << 24) - 2, LIVE_AIRCRAFT, replace=False) + 1):
        icao = int(icao)
        lat, lon = rng.uniform(50.0, 54.0), rng.uniform(2.0, 7.0)
        alt = 25 * int(rng.integers(400, 1520))
        ew, ns = (int(v) for v in rng.integers(-400, 401, 2))
        for kind, rate in LIVE_RATES:
            t = rng.uniform(0.0, 1.0 / rate)
            odd = False
            while t < seconds:
                if kind == "position":
                    cpr_lat, cpr_lon = synth.encode_airborne_cpr(lat, lon, odd)
                    frame = synth.make_df17(icao, synth.make_position_me(11, alt, cpr_lat, cpr_lon, odd))
                    odd = not odd
                elif kind == "velocity":
                    frame = synth.make_df17(icao, synth.make_velocity_me(ew, ns, vertical_rate_fpm=64 * (a % 20 - 10)))
                elif kind == "id":
                    frame = synth.make_df17(icao, synth.make_id_me(f"LV{a:04d}"))
                elif kind == "df11":
                    frame = shortframe.make_df11(icao)
                elif kind == "df4":
                    frame = shortframe.make_df4(icao, alt)
                elif kind == "df5":
                    frame = shortframe.make_df5(icao, 1000 + a)
                else:
                    frame = shortframe.make_df20(icao, alt, mb=synth.make_id_me(f"LV{a:04d}"))
                offsets.append(int(t * 2e6))
                frames.append(frame)
                t += rng.uniform(0.8, 1.2) / rate
    iq = torch.as_tensor(synth.modulate(frames, offsets, n, amplitude=3000.0, seed=seed)).to(device)
    blocks = []
    for j in range(n_blocks):
        chunk = iq[j * LIVE_BLOCK : (j + 1) * LIVE_BLOCK + LIVE_OVERLAP]
        capacity = 256
        out = to_host(decode_iq_block_extended_with_fields(chunk, LIVE_BLOCK, capacity))
        while bool(out["overflow"]) and capacity < LIVE_BLOCK:
            capacity = min(capacity * 4, LIVE_BLOCK)
            out = to_host(decode_iq_block_extended_with_fields(chunk, LIVE_BLOCK, capacity))
        blocks.append(out)
    return blocks


def time_sink_calls(blocks: list[dict], passes: int = 5, gap_s: float = 0.0) -> dict:
    """WebDisplay(quiet=True, extended_schema=True).batched_sink(extended=True)
    over `blocks` in turn (block j at 10 ms a block), each call after
    `gap_s` seconds of sleep, a fresh display a pass -> the median ms a call
    of the fastest pass, and the summaries the last
    pass sent; decode_pairs' median µs a call on the pairs of
    synth.encode_airborne_cpr over 3 and over 12 aircraft."""
    from airjax_torch.track.cpr_batch import decode_pairs
    from airjax_torch.track.icao_cache import IcaoCache
    from airjax_torch.ui.web import WebDisplay

    best = None
    for _ in range(passes):
        display = WebDisplay(quiet=True, extended_schema=True)
        sink = display.batched_sink(extended=True)
        cache = IcaoCache()
        spent = []
        for j, out in enumerate(blocks):
            if gap_s:
                time.sleep(gap_s)
            t0 = time.perf_counter()
            sink.on_extended_block(out, 1000.0 + 0.01 * j, cache)
            spent.append(time.perf_counter() - t0)
        med = statistics.median(spent) * 1e3
        best = med if best is None else min(best, med)
    result = {"sink_ms": best, "summaries_sent": display.broadcast.sent}
    for n in (3, 12):
        pairs = [synth.encode_airborne_cpr(52.0 + i / 10, 4.0 + i / 10, odd) for i in range(n) for odd in (False, True)]
        e_lat, e_lon = zip(*pairs[0::2])
        o_lat, o_lon = zip(*pairs[1::2])
        newest = [i % 2 == 0 for i in range(n)]
        spent = []
        for _ in range(200):
            t0 = time.perf_counter()
            decode_pairs(e_lat, e_lon, o_lat, o_lon, newest)
            spent.append(time.perf_counter() - t0)
        result[f"decode_pairs_us_{n}"] = statistics.median(spent) * 1e6
    return result


def time_sink_parts(blocks: list[dict], passes: int = 5) -> dict:
    """The same sink's call cut into its parts, run one after another on
    the display's own tracker as on_extended_block runs them: selection
    (track.batch.select_rows), gating (_gate), the walk (_walk_block), CPR
    (_resolve_pairs), the summaries (the display's on_applied) -> each
    part's median ms a block in the pass whose parts sum least; rows and
    messages a block (medians), and the share of blocks holding a row of
    the per-packet path."""
    from airjax_torch.track.batch import select_rows
    from airjax_torch.track.icao_cache import IcaoCache
    from airjax_torch.ui.web import WebDisplay

    names = ("select", "gate", "walk", "cpr", "summaries")
    best = None
    for _ in range(passes):
        display = WebDisplay(quiet=True, extended_schema=True)
        tracker = display.batched_sink(extended=True).tracker
        cache = IcaoCache()
        parts = {name: [] for name in names}
        rows, applied, with_fallback = [], [], 0
        for j, out in enumerate(blocks):
            now = 1000.0 + 0.01 * j
            t0 = time.perf_counter()
            sel = select_rows(out)
            t1 = time.perf_counter()
            kept, addr, kind = tracker._gate(out, sel, now, cache, None)
            t2 = time.perf_counter()
            pair_jobs, touched = [], set()
            n, fallbacks = tracker._walk_block(out, kept, addr, kind, now, pair_jobs, touched)
            t3 = time.perf_counter()
            tracker._resolve_pairs(pair_jobs)
            t4 = time.perf_counter()
            if n:
                tracker.on_applied(touched)
            t5 = time.perf_counter()
            for name, dt in zip(names, (t1 - t0, t2 - t1, t3 - t2, t4 - t3, t5 - t4)):
                parts[name].append(dt)
            rows.append(len(sel))
            applied.append(n)
            with_fallback += fallbacks > 0
        meds = {f"{name}_ms": statistics.median(v) * 1e3 for name, v in parts.items()}
        if best is None or sum(meds.values()) < sum(best.values()):
            best = meds
    return {**best, "rows_a_block": statistics.median(rows), "messages_a_block": statistics.median(applied),
            "blocks_with_fallback": with_fallback / len(blocks)}


def run_sink(n_blocks: int, *, device: torch.device | str = "cuda", gap_ms: float = 0.0) -> dict:
    """The --sink line: the live sink's call and its parts."""
    blocks = build_live_blocks(n_blocks, device=device)
    return {"blocks": n_blocks, "gap_ms": gap_ms, **time_sink_calls(blocks, gap_s=gap_ms / 1e3),
            **time_sink_parts(blocks)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--messages", type=int, default=200_000)
    ap.add_argument("--torch-device", choices=["cuda", "cpu"], default="cuda",
                    help="where the extended block is decoded: cuda (default; fails without a card) or the CPU")
    ap.add_argument("--sink", action="store_true",
                    help="time the web map's extended batched sink in parts instead (see the module's docstring)")
    ap.add_argument("--blocks", type=int, default=300, help="--sink: busy-sky blocks to time")
    ap.add_argument("--gap-ms", type=float, default=0.0, help="--sink: ms of sleep before each whole call")
    args = ap.parse_args(argv)
    device = check_device(args.torch_device)
    if args.sink:
        print(json.dumps(run_sink(args.blocks, device=device, gap_ms=args.gap_ms)))
        return 0
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
