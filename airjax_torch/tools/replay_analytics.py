#!/usr/bin/env python3
"""Whole-capture replay analytics: .c16 -> a track report per aircraft
(tools/replay_analytics.py, on the port).

Decodes the whole capture (airjax_torch.analytics) and prints one JSON
object per aircraft (callsign, messages, altitude range, every position
fix), and the stats on standard error:

  python3 airjax_torch/tools/replay_analytics.py capture.c16 [--json out.json]
      [--extended [--ref-lat LAT --ref-lon LON]] [--devices N] [--torch-device cuda|cpu]

--extended decodes every Mode S downlink format and adds the velocity,
squawk and packet-kind histories; --devices N decodes over the halo-sharded
mesh of the first N cards (N CPU shards with --torch-device cpu).
"""

import argparse
import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent.parent))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("capture", help=".c16 capture file")
    ap.add_argument("--json", default=None, help="also write a JSON report")
    ap.add_argument("--extended", action="store_true",
                    help="decode every Mode S downlink format; adds velocity/squawk/kind histories per aircraft")
    ap.add_argument("--ref-lat", type=float, default=None)
    ap.add_argument("--ref-lon", type=float, default=None)
    ap.add_argument("--devices", type=int, default=None, metavar="N",
                    help="decode over the halo-sharded mesh of the first N devices (the same hits)")
    ap.add_argument("--torch-device", choices=["cuda", "cpu"], default="cuda",
                    help="where the decode runs (default cuda; raises without a card)")
    args = ap.parse_args()

    import torch

    from airjax_torch.analytics import analyze_capture, analyze_capture_extended
    from airjax_torch.io.c16 import load_c16

    if args.torch_device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--torch-device cuda: no CUDA device is available (pass --torch-device cpu)")
    iq = load_c16(args.capture)
    if args.extended:
        ref = (args.ref_lat, args.ref_lon) if args.ref_lat is not None and args.ref_lon is not None else None
        tracks, stats = analyze_capture_extended(iq, ref_position=ref, devices=args.devices,
                                                 device=args.torch_device)
    else:
        tracks, stats = analyze_capture(iq, devices=args.devices, device=args.torch_device)

    report = []
    for icao, t in sorted(tracks.items()):
        alts = [a for _, a in t.altitudes]
        report.append({
            "icao": f"{icao:06x}",
            "callsign": t.callsign,
            "messages": t.n_messages,
            "altitude_ft": [min(alts), max(alts)] if alts else None,
            "fixes": [{"offset": fx.offset, "t_s": round(fx.offset / 2e6, 3), "lat": round(fx.latitude, 6),
                       "lon": round(fx.longitude, 6), "alt_ft": fx.altitude_ft} for fx in t.fixes],
        })
        if args.extended:
            report[-1]["kinds"] = t.kinds
            report[-1]["squawks"] = t.squawks
            report[-1]["velocities"] = [
                {"offset": off, "gs_kt": None if gs is None else round(gs, 1),
                 "track_deg": None if tr is None else round(tr, 1), "vr_fpm": vr}
                for off, gs, tr, vr in t.velocities
            ]
    for entry in report:
        print(json.dumps(entry))
    print(f"stats: {json.dumps(stats)}", file=sys.stderr)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"aircraft": report, "stats": stats}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
