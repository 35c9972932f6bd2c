#!/usr/bin/env python3
"""Continuous-stream soak (tools/soak.py, on the port): run the overlap-save
block pipeline on a continuous synthetic stream for N seconds on one card
and verify zero boundary loss.

Every block carries exactly `frames_per_block` frames, one of which is
placed straddling the previous block boundary (the class the reference
demonstrably drops, src/adsb.rs:75-89) — so expected decodes are exactly
countable and any boundary loss shows up as a deficit.

  python3 airjax_torch/tools/soak.py [--seconds 60] [--block 200000]
      [--extended [--rotate N] [--evict S]] [--recover2] [--memcheck]
      [--sdr] [--devices N] [--pipeline-depth D] [--torch-device cuda|cpu]

With --sdr, the stream comes from a live sdr.SdrSource instead of the
synthetic generator — pointed at the fake SoapySDR ABI double
(AIRJAX_SOAPY_LIB=<native.build_fake_soapysdr()>,
AIRJAX_FAKE_SOAPY_C16=<capture>) this soaks the whole live path: ctypes
FFI -> MTU blocks -> the native ring -> overlap-save decode. The decode
count is checked against the backing capture's frame density: 3 frames
in the interior of a 20,000-sample capture (one MTU block of the fake).
--devices N soaks run_stream_sharded over N cards (N CPU shards with
--torch-device cpu); --pipeline-depth sets either runner's decodes in
flight (default 1, the runners' own default), for an A/B of the overlap.
--memcheck adds the RSS plateau, the no-regrow ratchet and, with
--rotate/--evict, the bounded tracker. Prints one JSON line; exit 0 when
every check held.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

sys.path.insert(0, str(__import__("pathlib").Path(__file__).resolve().parent.parent.parent))

from airjax_torch.io import synth  # noqa: E402


def _rss_mb() -> float:
    """Resident set size in MB (Linux /proc)."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 1024.0
    return 0.0


class MemWatch:
    """RSS sampler for long soaks: proves the long-run story — memory plateaus instead of creeping. Samples RSS on
    a thread; verdict() compares the late-phase peak against the
    post-warmup peak (first quarter is warmup: compile caches, buffer
    pools and the tracker reaching steady state)."""

    def __init__(self, interval_s: float = 5.0):
        import threading

        self.samples: list[tuple[float, float]] = []
        self._stop = threading.Event()
        self._t0 = time.time()

        def loop():
            while not self._stop.wait(interval_s):
                self.samples.append((time.time() - self._t0, _rss_mb()))

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def finish(self) -> dict:
        self._stop.set()
        self._thread.join(timeout=2)
        self.samples.append((time.time() - self._t0, _rss_mb()))
        return self.verdict()

    def verdict(self, slack_mb: float = 32.0, ratio: float = 1.10) -> dict:
        n = len(self.samples)
        rss = [r for _, r in self.samples]
        if n < 4:
            return {"rss_ok": True, "rss_samples": n, "rss_end_mb": rss[-1] if rss else 0}
        warm = rss[max(1, n // 4):]  # drop the warmup quarter
        early_peak = max(warm[: max(1, len(warm) // 2)])
        late_peak = max(warm[len(warm) // 2:])
        return {
            "rss_ok": late_peak <= early_peak * ratio + slack_mb,
            "rss_samples": n,
            "rss_start_mb": round(rss[0], 1),
            "rss_early_peak_mb": round(early_peak, 1),
            "rss_late_peak_mb": round(late_peak, 1),
            "rss_end_mb": round(rss[-1], 1),
        }


def boundary_stream(
    block: int, stop_flag: dict, seed: int = 0, corrupt_every: int = 0
):
    """Endless blocks; each carries a mid-block frame plus a frame whose
    head sits in this block and whose tail crosses into the next one.

    Per yielded block b: frame 1 at local offset 2000, frame 2 at local
    offset block-120 (straddling the b/b+1 boundary; its 120-sample tail
    is stitched into the head of block b+1). Expected decodes after B
    blocks: 2B - 1 (the final straddler never completes).

    corrupt_every=N (recover2 soak): every Nth block's MID frame (b>=1,
    b%N==0) carries a 2-bit-corrupted transmission — undecodable by the
    parity pipeline, repairable by the gated 2-flip recovery (the ICAO
    is seen clean from block 0 on, so every repair is accepted). The
    expected total stays 2B-1 and the repair count is countable.
    """
    frame = synth.make_df17(0x7C6B30, synth.make_id_me("SOAK"))
    corrupt = synth.flip_bit(synth.flip_bit(frame, 21), 69)
    window = 240
    tail = None
    b = 0
    while not stop_flag.get("stop"):
        mid = (
            corrupt
            if corrupt_every and b >= 1 and b % corrupt_every == 0
            else frame
        )
        seg = synth.modulate(
            [mid, frame], [2000, block - 120], block + window, seed=seed + b
        )
        out = seg[:block].copy()
        if tail is not None:
            out[:window] = tail  # completes the previous straddler
        tail = seg[block : block + window].copy()
        yield out
        b += 1


def sdr_soak(seconds: float, runner, extended: bool = False, devices: int | None = None) -> int:
    """Soak the LIVE path: SdrSource (usually the fake SoapySDR double)
    -> overlap-save decode. The fake cycles one 20k-sample MTU block, so
    each delivered block carries a known frame count and the expected
    decode total is countable (straddlers included: the capture embeds
    frames only in the interior, so block boundaries never cut one).
    With extended=True the full-format pipeline + batched sink
    (ExtendedBatchTracker) consume the same stream."""
    from airjax_torch import sdr

    t0 = time.time()
    src = sdr.SdrSource(device=0)

    def timed_blocks():
        # Production live path: rx thread -> native SPSC ring -> decode.
        for blk in src.blocks_ringbuffered():
            if time.time() - t0 > seconds:
                return
            yield blk

    if extended:
        from airjax_torch.track.batch import ExtendedBatchTracker

        sink = ExtendedBatchTracker()
        stats = runner(timed_blocks(), sink, extended=True)
        n_decoded = sink.n_messages
    else:
        frames_seen = []
        sink = lambda pkt: frames_seen.append(pkt.icao)  # noqa: E731
        stats = runner(timed_blocks(), sink)
        n_decoded = len(frames_seen)
    src.close()
    d = stats.as_dict()
    frames_per_block = 3  # the fake's capture layout (module docstring)
    # Sharded runner counts steps in d["blocks"]; derive delivered MTU
    # blocks from the sample count (the fake cycles 20k-sample blocks;
    # frames sit in the interior, so boundaries never cut one).
    n_blocks = d["blocks"] if devices is None else d["samples"] // 20000
    expected = n_blocks * frames_per_block
    d.update(
        mode="sdr-extended-batched" if extended else "sdr",
        seconds=round(time.time() - t0, 1),
        frames_decoded=n_decoded,
        frames_expected=expected,
        boundary_loss=max(0, expected - n_decoded),
    )
    print(json.dumps(d))
    # Exact equality, not just no-deficit: a misconfigured fake (e.g.
    # AIRJAX_FAKE_SOAPY_C16 unset -> zero samples -> the all-zero
    # CRC-passes-everywhere storm) decodes far MORE than expected and
    # must fail the soak, not sneak past a deficit-only check.
    ok = n_blocks > 0 and n_decoded == expected
    return 0 if ok else 1


def extended_boundary_stream(
    block: int, stop_flag: dict, seed: int = 0, rotate: int = 0,
    corrupt_every: int = 0,
):
    """Extended-mode variant of boundary_stream: per block a mid-block
    DF17, a mid-block DF11 all-call (short-frame class) and a DF17
    straddling the boundary. Expected decodes after B blocks: 3B - 1.

    With rotate=N, each block's DF17s use ICAO 0x7C0000 + (b mod N) —
    an endless parade of distinct aircraft, so an evicting tracker must
    stay bounded (the no-tracker-growth memcheck assertion).

    corrupt_every=M (recover2 soak): every Mth block's MID DF17 (b>=1)
    transmits with 2 flipped bits — only the gated repair recovers it
    (the acceptance cache holds its ICAO continuously), so the expected
    total stays 3B-1 iff the repair path works at scale."""
    from airjax_torch.protocol import shortframe

    df11 = shortframe.make_df11(0x40621D)
    window = 240
    tail = None
    b = 0
    while not stop_flag.get("stop"):
        icao = 0x7C0000 + (b % rotate) if rotate else 0x7C6B30
        df17 = synth.make_df17(icao, synth.make_id_me("SOAKEXT"))
        mid = (
            synth.flip_bit(synth.flip_bit(df17, 21), 69)
            if corrupt_every and b >= 1 and b % corrupt_every == 0
            else df17
        )
        seg = synth.modulate(
            [mid, df11, df17],
            [2000, 6000, block - 120],
            block + window,
            seed=seed + b,
        )
        out = seg[:block].copy()
        if tail is not None:
            out[:window] = tail
        tail = seg[block : block + window].copy()
        yield out
        b += 1


def _runner(devices: int | None, device: str, pipeline_depth: int):
    """run_stream on `device`, or run_stream_sharded over `devices` mesh
    shards (the `adsb --devices N` path), with the same sink contract and
    `pipeline_depth` decodes in flight."""
    from airjax_torch.runner import run_stream, run_stream_sharded

    def single(source, sink, overlap=True, extended=False, stats=None, recover2=False):
        return run_stream(source, sink, overlap=overlap, extended=extended, stats=stats, recover2=recover2,
                          device=device, pipeline_depth=pipeline_depth)

    def sharded(source, sink, overlap=True, extended=False, stats=None, recover2=False):
        if not overlap:
            raise ValueError("the sharded runner is always overlap-save")
        return run_stream_sharded(source, sink, n_devices=devices, extended=extended, stats=stats,
                                  recover2=recover2, device=device, pipeline_depth=pipeline_depth)

    return single if devices is None else sharded


def extended_soak(
    seconds: float,
    block: int,
    runner,
    memcheck: bool = False,
    rotate: int = 0,
    evict: float | None = None,
    devices: int | None = None,
    recover2: bool = False,
) -> int:
    """Soak the extended-mode BATCHED host path (ExtendedBatchTracker ->
    on_extended_block): continuous stream, zero boundary loss, tracker
    consistency. With memcheck, additionally assert the long-run story:
    RSS plateaus, no block ever needed a capacity regrow (ratchet), and
    with rotation+eviction the tracker table stays bounded."""
    from airjax_torch.track.batch import ExtendedBatchTracker

    stop = {}
    t0 = time.time()
    bt = ExtendedBatchTracker(evict_after_s=evict)
    mem = MemWatch() if memcheck else None

    def timed_stream():
        for blk in extended_boundary_stream(
            block, stop, rotate=rotate,
            corrupt_every=3 if recover2 else 0,
        ):
            if time.time() - t0 > seconds:
                return
            yield blk

    stats = runner(timed_stream(), bt, overlap=True, extended=True, recover2=recover2)
    d = stats.as_dict()
    if devices is None:
        expected = 3 * d["blocks"] - 1  # final straddler never completes
    else:
        # The sharded runner counts STEPS, not source blocks; count
        # expected frames from delivered samples instead (3 per source
        # block, final straddler never completes).
        expected = 3 * (d["samples"] // block) - 1
    if rotate:
        # Rotating fleet: every decode still lands; with eviction the
        # table must stay bounded by the ICAOs alive inside the eviction
        # window at the OBSERVED block rate (the soak free-runs, it is
        # not paced to real time), far below the distinct ICAOs seen.
        distinct_seen = min(rotate, d["blocks"]) + 1  # + the fixed DF11
        if evict is None:
            bound = distinct_seen + 1
        else:
            rate = d["blocks"] / max(time.time() - t0, 1e-9)
            bound = min(int(rate * evict * 1.5) + 16, distinct_seen + 1)
        ok_tracker = 0 < len(bt.aircrafts) <= bound
    else:
        ok_tracker = (
            set(bt.aircrafts) == {0x7C6B30, 0x40621D}
            and bt.aircrafts[0x7C6B30].callsign == "SOAKEXT_"
        )
    d.update(
        mode="extended-batched",
        seconds=round(time.time() - t0, 1),
        frames_decoded=bt.n_messages,
        frames_expected=expected,
        boundary_loss=max(0, expected - bt.n_messages),
        tracker_ok=ok_tracker,
        tracker_size=len(bt.aircrafts),
    )
    ok = d["boundary_loss"] == 0 and ok_tracker
    if mem is not None:
        d.update(mem.finish())
        # Regrow-capacity ratchet: at this known frame density NO block
        # should ever have overflowed the starting capacity.
        d["regrow_ok"] = d["overflow_blocks"] == 0
        ok = ok and d["rss_ok"] and d["regrow_ok"]
    print(json.dumps(d))
    return 0 if ok else 1


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--seconds", type=float, default=60.0)
    p.add_argument("--block", type=int, default=200000)
    p.add_argument("--sdr", action="store_true", help="soak the live SdrSource path")
    p.add_argument(
        "--extended", action="store_true",
        help="soak the extended-mode batched host path",
    )
    p.add_argument(
        "--memcheck", action="store_true",
        help="long-run memory assertions: RSS plateau + no regrow ratchet"
        " (+ bounded tracker with --rotate/--evict)",
    )
    p.add_argument(
        "--rotate", type=int, default=0, metavar="N",
        help="extended soak: rotate DF17 ICAOs over N distinct aircraft",
    )
    p.add_argument(
        "--evict", type=float, default=None, metavar="S",
        help="extended soak: tracker eviction window in seconds",
    )
    p.add_argument(
        "--recover2", action="store_true",
        help="parity soak: every 3rd block's mid frame is 2-bit "
        "corrupted and must come back through the GATED repair "
        "(exact recovered2 accounting)",
    )
    p.add_argument(
        "--devices", type=int, default=None, metavar="N",
        help="soak the sharded streaming runner over the first N cards "
        "(the adsb --devices N path; N CPU shards with --torch-device cpu)",
    )
    p.add_argument(
        "--pipeline-depth", type=int, default=1, metavar="D",
        help="decodes kept in flight by the runner (0: serial; default 1)",
    )
    p.add_argument(
        "--torch-device", choices=["cuda", "cpu"], default="cuda",
        help="where the decode runs (default cuda; raises without a card)",
    )
    args = p.parse_args(argv)
    runner = _runner(args.devices, args.torch_device, args.pipeline_depth)

    if args.sdr:
        return sdr_soak(args.seconds, runner, extended=args.extended, devices=args.devices)
    if args.extended:
        if args.recover2 and args.rotate:
            # A rotating fleet's corrupted mid frame belongs to an ICAO
            # whose first CLEAN sighting (its own straddler) decodes one
            # block later — the gate rightly rejects it and the exact
            # 3B-1 accounting no longer holds.
            print("error: --recover2 soak is incompatible with --rotate",
                  file=sys.stderr)
            return 2
        return extended_soak(
            args.seconds, args.block, runner, memcheck=args.memcheck,
            rotate=args.rotate, evict=args.evict, devices=args.devices,
            recover2=args.recover2,
        )

    mem = MemWatch() if args.memcheck else None
    stop = {}
    frames_seen = []
    t0 = time.time()

    def on_packet(pkt):
        frames_seen.append(pkt.icao)
        if time.time() - t0 > args.seconds:
            stop["stop"] = True

    corrupt_every = 3 if args.recover2 else 0

    def timed_stream():
        for blk in boundary_stream(
            args.block, stop, corrupt_every=corrupt_every
        ):
            if time.time() - t0 > args.seconds:
                return
            yield blk

    stats = runner(timed_stream(), on_packet, overlap=True, recover2=args.recover2)
    d = stats.as_dict()
    if args.devices is None:
        n_blocks = d["blocks"]
    else:
        # Sharded runner: stats.blocks counts steps; derive the source-
        # block count from delivered samples.
        n_blocks = d["samples"] // args.block
    expected = 2 * n_blocks - 1  # final straddler never completes
    d.update(
        seconds=round(time.time() - t0, 1),
        frames_decoded=len(frames_seen),
        frames_expected=expected,
        boundary_loss=max(0, expected - len(frames_seen)),
    )
    ok = d["boundary_loss"] == 0
    if args.recover2:
        # Every corrupted mid frame (blocks b>=1, b%3==0) must have come
        # back through the gated repair — an exact count, so a silently
        # ungated or unrepaired frame fails the soak either way.
        d["recover2_expected"] = (n_blocks - 1) // 3 if n_blocks else 0
        d["recover2_ok"] = d["recovered2"] == d["recover2_expected"]
        ok = ok and d["recover2_ok"]
    if mem is not None:
        d.update(mem.finish())
        d["regrow_ok"] = d["overflow_blocks"] == 0
        ok = ok and d["rss_ok"] and d["regrow_ok"]
    print(json.dumps(d))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
