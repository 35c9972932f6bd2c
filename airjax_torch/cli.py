"""The port's command line (airjax/cli.py):

  python -m airjax_torch.cli list
  python -m airjax_torch.cli receive <frequency> <sample_rate> <gain> <period>
                                     [-d DEVICE] [--synthetic]
  python -m airjax_torch.cli adsb [--playback FILE | --synthetic N] [--fast]
                                  [-m {stream,interactive,web}] [--port N]
                                  [--no-overlap] [--max-blocks N]
                                  [--extended] [--recover2] [--batched]
                                  [--jsonl PATH] [--state FILE]
                                  [--ref-lat LAT --ref-lon LON]
                                  [--evict-after SECONDS] [--devices N]
                                  [--plot-dir DIR] [--dump-preamble]
                                  [--trace DIR]
                                  [-d/--device N] [--torch-device cuda|cpu]

`list` enumerates the SDR devices and `receive` captures `period` seconds
of IQ from one (`-d`) into `data_<frequency>_<sample_rate>_<gain>` in the
working directory, or with `--synthetic` the synthetic stream (sdr.py:
SoapySDR through ctypes; without it both print the error and exit 1).
`adsb` decodes a playback (`--playback`, which wins over `--synthetic`),
the synthetic stream, or, given neither, the live SDR `-d/--device N`
through the native ring (sdr.SdrSource.blocks_ringbuffered), closed however
the decode stops; `--max-blocks N` bounds any source.

Stream mode (the default) prints the reference's Display of every decoded
packet (a DF17 packet opens with `== <hex> ==`) and a final `stats:` line;
`--jsonl` also appends each packet as a JSON line. `-m interactive` is
the curses aircraft table, `-m web` the web map (HTTP on --port, a
WebSocket broadcast at /ws, /api/aircraft); both track aircraft, per
packet or, with `--batched`, a block at a time through the batched
tracker, and `--state` restores and saves their table. `--extended`
decodes every Mode S downlink format; `--recover2` also accepts frames
that a unique 2-bit repair validated, gated on an ICAO already seen.
`--torch-device` (the port's own flag) defaults to cuda; without a card
that raises — the port never falls back to the CPU on its own. `--devices
N` decodes the stream over the first N cards (runner.run_stream_sharded),
or with `--torch-device cpu` over N CPU shards. Either runner keeps one
decode in flight while the previous one is fetched (pipeline_depth 1, as
airjax's `adsb`). The debug aids, in stream mode:
`--plot-dir DIR` writes an SVG plot of each DF17 frame's magnitudes (it
needs matplotlib), `--dump-preamble` prints each frame's preamble; both
are refused with --devices (exit 2), as airjax refuses them. `--trace DIR`
writes a torch.profiler trace of the run (the card's kernels included) to
DIR, with the runner's stage spans of every block on tracks of their own.
Each mode logs its final stats on the `airjax_torch` logger
(observability.log_stats): airjax's keys, then `backlog_max`,
`early_fetches`, in web mode `summaries_sent` and `summaries_dropped`,
and with `--batched --extended` the tracker's `batched_blocks` and
`fallback_rows` (`_stats_line`).
"""

from __future__ import annotations

import argparse
import itertools
import os
import sys
import threading
import time

import torch


def _cmd_list(args) -> int:
    from airjax_torch import sdr

    try:
        for i, dev in enumerate(sdr.list_devices()):
            print(f"{i}: {dev}")
    except sdr.SdrUnavailable as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    return 0


def _cmd_receive(args) -> int:
    """airjax/cli.py:32-78: `period` seconds of IQ into
    data_<frequency>_<sample_rate>_<gain> in the working directory."""
    import numpy as np

    from airjax_torch.io.c16 import save_c16

    name = f"data_{args.frequency}_{args.sample_rate}_{args.gain}"
    if args.synthetic:
        from airjax_torch.io.source import synthetic_blocks

        n_samples = int(args.sample_rate * args.period)
        chunks, got = [], 0
        for block in synthetic_blocks(chunk=20000):
            chunks.append(block)
            got += len(block)
            if got >= n_samples:
                break
        data = np.concatenate(chunks)[:n_samples]
        save_c16(data, name)
        print(f"saved {len(data)} synthetic samples to {name}")
        return 0

    from airjax_torch import sdr

    try:
        source = sdr.SdrSource(device=args.device, frequency_hz=args.frequency, sample_rate_hz=args.sample_rate,
                               gain_db=args.gain)
    except sdr.SdrUnavailable as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    data = []
    start = time.time()
    try:
        for block in source.blocks():
            data.append(block)
            if time.time() - start >= args.period:
                break
    finally:
        source.close()
    all_data = np.concatenate(data)
    save_c16(all_data, name)
    print(f"saved {len(all_data)} samples to {name}")
    return 0


def _sdr_blocks(src, limit: int | None):
    """The live source's blocks through the native ring, at most `limit`;
    the SDR is closed however the consumer stops (the bound, the generator
    dropped, or an exception), so it never streams into a dead buffer."""
    try:
        for i, block in enumerate(src.blocks_ringbuffered()):
            if limit is not None and i >= limit:
                return
            yield block
    finally:
        src.close()


def _source(args):
    """The block source, or an exit code after an error message
    (airjax/cli.py:95-155)."""
    if args.playback:
        from airjax_torch.io.source import playback_blocks

        try:
            source = iter(playback_blocks(args.playback, realtime_factor=None if args.fast else 2.0))
            # Load the file now for a clean error message.
            first = next(source, None)
        except (OSError, ValueError) as e:
            print(f"error: couldn't load playback data file: {e}", file=sys.stderr)
            return 1
        source = itertools.chain([first], source) if first is not None else iter(())
    elif args.synthetic is not None:
        from airjax_torch.io.source import synthetic_blocks

        source = synthetic_blocks(n_blocks=args.synthetic)
    else:
        from airjax_torch import sdr

        try:
            src = sdr.SdrSource(device=args.device)
        except sdr.SdrUnavailable as e:
            print(f"error: {e}\nhint: use --playback FILE or --synthetic N", file=sys.stderr)
            return 1
        return _sdr_blocks(src, args.max_blocks)
    if args.max_blocks is not None:
        source = itertools.islice(source, args.max_blocks)
    return source


def _stats_line(stats, display=None, tracker=None) -> dict:
    """The final stats: airjax's (StreamStats.as_dict), then the operator's
    counters: `backlog_max`, the most blocks the source had ready and the
    runner not yet taken (above 0, the receiver fell behind),
    `early_fetches`, the decodes fetched without waiting for the next block
    because the source had none ready, for the web map `summaries_sent`
    and `summaries_dropped` (updates a lagging client lost), and for a
    batched extended sink (`tracker`, an ExtendedBatchTracker)
    `batched_blocks`, the blocks it applied, and `fallback_rows`, the rows
    of them that took the per-packet path."""
    line = {**stats.as_dict(), "backlog_max": stats.backlog_max, "early_fetches": stats.early_fetches}
    if display is not None:
        line.update(summaries_sent=display.broadcast.sent, summaries_dropped=display.broadcast.dropped)
    if tracker is not None:
        line.update(batched_blocks=tracker.blocks, fallback_rows=tracker.fallback_rows)
    return line


def _cmd_adsb(args) -> int:
    if args.trace:
        from airjax_torch import observability

        with observability.trace(args.trace):
            return _cmd_adsb_inner(args)
    return _cmd_adsb_inner(args)


def _cmd_adsb_inner(args) -> int:
    from airjax_torch import observability
    from airjax_torch.config import DEFAULT_CONFIG
    from airjax_torch.runner import StreamStats, run_stream, run_stream_sharded

    device = torch.device(args.torch_device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--torch-device cuda: no CUDA device is available (pass --torch-device cpu)")
    source = _source(args)
    if isinstance(source, int):
        return source
    if args.devices is not None and args.no_overlap:
        print("error: --devices requires overlap mode (the sharded runner's halo IS the overlap)", file=sys.stderr)
        return 2
    if args.devices is not None and (args.plot_dir or args.dump_preamble):
        print("error: --plot-dir/--dump-preamble are single-device debug aids; drop --devices to use them",
              file=sys.stderr)
        return 2

    def _run(source, sink, stats=None):
        if args.devices is not None:
            return run_stream_sharded(source, sink, n_devices=args.devices, extended=args.extended, stats=stats,
                                      recover2=args.recover2, device=device)
        # The debug aids print in stream mode only: the TUI owns the terminal.
        return run_stream(source, sink, overlap=not args.no_overlap, extended=args.extended, device=device,
                          stats=stats, recover2=args.recover2,
                          plot_dir=args.plot_dir if args.mode == "stream" else None,
                          dump_preamble=args.dump_preamble and args.mode == "stream")

    ref_position = None
    if (args.ref_lat is None) != (args.ref_lon is None):
        print("error: --ref-lat and --ref-lon must be given together", file=sys.stderr)
        return 2
    if args.ref_lat is not None:
        ref_position = (args.ref_lat, args.ref_lon)
    if args.batched and args.mode == "stream":
        print("warning: --batched has no effect in stream mode (its contract is one printed dump per packet)",
              file=sys.stderr)

    # --- tracker checkpoint and resume (airjax/cli.py:217-243) ---
    restored = None
    if args.state:
        if args.mode == "stream":
            print("warning: --state has no effect in stream mode (no tracker)", file=sys.stderr)
        elif os.path.exists(args.state):
            from airjax_torch.track.state import load_state

            try:
                restored = load_state(args.state)
                print(f"restored {len(restored)} aircraft from {args.state}")
            except (ValueError, KeyError, TypeError) as e:
                # ValueError covers json.JSONDecodeError too.
                print(f"error: bad state file {args.state}: {e}", file=sys.stderr)
                return 1

    def _save_state(aircrafts) -> None:
        if args.state and args.mode != "stream":
            from airjax_torch.track.state import save_state

            save_state(aircrafts, args.state)
            print(f"saved {len(aircrafts)} aircraft to {args.state}")

    if args.mode == "stream":
        from airjax_torch.ui.stream import jsonl_writer, stream_printer, tee

        sink = stream_printer()
        if args.jsonl:
            sink = tee(sink, jsonl_writer(args.jsonl))
        stats = _run(source, sink)
        observability.log_stats("adsb_stream_done", _stats_line(stats))
    elif args.mode == "interactive":
        from airjax_torch.ui.tui import TuiApp, interactive_display

        app = TuiApp(ref_position=ref_position, evict_after_s=args.evict_after)
        if restored:
            app.aircrafts.update(restored)
        sink = app.batched_sink(extended=args.extended) if args.batched else app.on_packet
        tracker = sink.tracker if args.batched and args.extended else None
        stop = threading.Event()

        def until_stopped(blocks):
            for block in blocks:
                if stop.is_set():
                    return
                yield block

        tui_stats = StreamStats()
        decode_thread = threading.Thread(
            target=_run, args=(until_stopped(source), sink), kwargs={"stats": tui_stats}, daemon=True
        )
        decode_thread.start()
        interactive_display(app)
        # Quit: the source ends at the next block and the decode thread
        # finishes what it holds. An interpreter that exits while a thread
        # is inside a torch op can abort ("terminate called without an
        # active exception").
        stop.set()
        decode_thread.join()
        with app._lock:
            _save_state(app.aircrafts)
        observability.log_stats("adsb_interactive_done", _stats_line(tui_stats, tracker=tracker))
        return 0
    else:  # web
        from airjax_torch.ui.web import WebDisplay

        display = WebDisplay(
            DEFAULT_CONFIG.web_host, port=args.port, quiet=False, extended_schema=args.extended,
            ref_position=ref_position, evict_after_s=args.evict_after,
        )
        display.start_background()
        if restored:
            display.aircrafts.update(restored)
        sink = display.batched_sink(extended=args.extended) if args.batched else display.on_packet
        tracker = sink.tracker if args.batched and args.extended else None
        try:
            stats = _run(source, sink)
            observability.log_stats("adsb_web_done", _stats_line(stats, display, tracker))
            print("source exhausted; web server still running (Ctrl-C to quit)")
            while True:
                time.sleep(1)
        except KeyboardInterrupt:
            return 0
        finally:
            with display._lock:
                _save_state(display.aircrafts)

    print(f"\nstats: {_stats_line(stats)}")
    return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="airjax_torch", description="ADS-B / Mode S decode on PyTorch/CUDA"
    )
    sub = parser.add_subparsers(dest="command", required=True)
    sub.add_parser("list", help="enumerate SDR devices")
    receive = sub.add_parser("receive", help="capture IQ to a .c16 file")
    receive.add_argument("frequency", type=float, help="Frequency in Hz")
    receive.add_argument("sample_rate", type=float, help="Sample rate in Hz")
    receive.add_argument("gain", type=float, help="Gain")
    receive.add_argument("period", type=int, help="Period in seconds")
    receive.add_argument("-d", "--device", type=int, default=None, help="SDR device index")
    receive.add_argument("--synthetic", action="store_true", help="capture the synthetic stream instead")
    adsb = sub.add_parser("adsb", help="decode and display ADS-B traffic")
    adsb.add_argument("-d", "--device", type=int, default=None,
                      help="SDR device index of the live input (read when neither --playback nor --synthetic is given)")
    adsb.add_argument("-m", "--mode", choices=["web", "interactive", "stream"], default="stream")
    adsb.add_argument("-p", "--playback", default=None, help=".c16 capture to replay (wins over --synthetic)")
    adsb.add_argument("--synthetic", type=int, default=None, metavar="N")
    adsb.add_argument("--max-blocks", type=int, default=None, metavar="N",
                      help="stop after N source blocks (bounds live SDR runs)")
    adsb.add_argument("--no-overlap", action="store_true", help="reference chunking: boundary frames lost")
    adsb.add_argument("--fast", action="store_true", help="replay without the 2x-real-time sleep")
    adsb.add_argument("--port", type=int, default=8080, help="web mode: the HTTP port")
    adsb.add_argument("--plot-dir", default=None, help="stream mode: an SVG magnitude plot per DF17 frame in DIR")
    adsb.add_argument(
        "--dump-preamble", action="store_true",
        help="stream mode: print a textual preamble dump (block graph + magnitude/index table) per decoded frame "
        "(the reference's print_preamble helpers, src/visualise.rs:38-62)",
    )
    adsb.add_argument("--jsonl", default=None, help="append decoded packets as JSON lines")
    adsb.add_argument(
        "--extended", action="store_true",
        help="decode all Mode S downlink formats (DF0/4/5/11/16/20/21/24), not just DF17",
    )
    adsb.add_argument(
        "--batched", action="store_true",
        help="web/interactive modes: the batched tracker sink, a block at a time (fields from the card); "
        "web also coalesces the WS broadcast to one summary per touched aircraft per block",
    )
    adsb.add_argument(
        "--state", default=None, metavar="FILE",
        help="tracker checkpoint: restore at start, save on exit (web/interactive modes)",
    )
    adsb.add_argument("--ref-lat", type=float, default=None, help="receiver latitude (enables surface-position decode)")
    adsb.add_argument("--ref-lon", type=float, default=None, help="receiver longitude (enables surface-position decode)")
    adsb.add_argument(
        "--recover2", action="store_true",
        help="also accept frames repaired by a unique DOUBLE bit-flip, gated on an already-validated ICAO "
        "(the stream's seen-set, or the acceptance cache with --extended); composes with --extended, --batched and "
        "--devices",
    )
    adsb.add_argument(
        "--evict-after", type=float, default=None, metavar="SECONDS",
        help="drop aircraft unheard for SECONDS (web/interactive modes; default: never)",
    )
    adsb.add_argument(
        "--devices", type=int, default=None, metavar="N",
        help="shard the decode over the first N devices of the mesh (continuous stream, halo between shards, "
        "carry between steps; with --torch-device cpu, N CPU shards); default: the single-device runner",
    )
    adsb.add_argument(
        "--trace", default=None, metavar="DIR",
        help="write a torch.profiler trace of the run (host and card) to DIR (chrome://tracing, ui.perfetto.dev)",
    )
    adsb.add_argument("--torch-device", choices=["cuda", "cpu"], default="cuda",
                      help="where the decode runs (default cuda; raises without a card)")
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return {"list": _cmd_list, "receive": _cmd_receive, "adsb": _cmd_adsb}[args.command](args)


if __name__ == "__main__":
    sys.exit(main())
