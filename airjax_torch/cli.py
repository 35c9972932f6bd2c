"""The port's command line, stream mode only (airjax/cli.py:92-190, :345-357):

  python -m airjax_torch.cli adsb [--playback FILE | --synthetic N] [--fast]
                                  [--no-overlap] [--max-blocks N]
                                  [--extended] [--jsonl PATH]
                                  [--device cuda|cpu]

Prints the reference's Display of every decoded packet (a DF17 packet
opens with `== <hex> ==`) and a final `stats:` line; `--jsonl` also
appends each packet as a JSON line; `--extended` decodes every Mode S
downlink format, not just DF17.
`--device` defaults to cuda; without a card that raises — the port never
falls back to the CPU on its own.
"""

from __future__ import annotations

import argparse
import itertools
import sys

import torch


def _cmd_adsb(args) -> int:
    from airjax_torch.runner import run_stream
    from airjax_torch.ui.stream import jsonl_writer, stream_printer, tee

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available (pass --device cpu)")

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
        print("error: give --playback FILE or --synthetic N (live SDR input is not ported)", file=sys.stderr)
        return 1
    if args.max_blocks is not None:
        source = itertools.islice(source, args.max_blocks)

    sink = stream_printer()
    if args.jsonl:
        sink = tee(sink, jsonl_writer(args.jsonl))
    stats = run_stream(
        source, sink, overlap=not args.no_overlap, extended=args.extended, device=device
    )
    print(f"\nstats: {stats.as_dict()}")
    return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="airjax_torch", description="ADS-B / Mode S decode on PyTorch/CUDA"
    )
    sub = parser.add_subparsers(dest="command", required=True)
    adsb = sub.add_parser("adsb", help="decode and print ADS-B packets")
    src = adsb.add_mutually_exclusive_group()
    src.add_argument("-p", "--playback", default=None, help=".c16 capture to replay")
    src.add_argument("--synthetic", type=int, default=None, metavar="N")
    adsb.add_argument("--max-blocks", type=int, default=None, metavar="N")
    adsb.add_argument("--no-overlap", action="store_true", help="reference chunking: boundary frames lost")
    adsb.add_argument("--fast", action="store_true", help="replay without the 2x-real-time sleep")
    adsb.add_argument("--jsonl", default=None, help="append decoded packets as JSON lines")
    adsb.add_argument(
        "--extended", action="store_true",
        help="decode all Mode S downlink formats (DF0/4/5/11/16/20/21/24), not just DF17",
    )
    adsb.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return {"adsb": _cmd_adsb}[args.command](args)


if __name__ == "__main__":
    sys.exit(main())
