#!/usr/bin/env python3
"""SNR sensitivity sweep (tools/snr_sweep.py, on the port; BASELINE config
2): the decode rate against SNR of batches of synthetic captures, from the
port's decodes, optionally held to its golden scalar decoder — the curves
must coincide, since the decodes are bit-identical.

  python3 airjax_torch/tools/snr_sweep.py [--captures 8] [--frames 8] [--golden]
      [--extended] [--recover2] [--json OUT] [--torch-device cuda|cpu]

The captures are synth.modulate's, which is byte-identical to airjax's, so
the curves equal airjax's tool's, point for point. --golden: the device
curve must equal the golden decoder's; --recover2: the gated 2-bit repair's
rate must be at least the standard rate, with no false accept. Exit 1 when
one of them fails, 0 otherwise; the result is printed as JSON, and the
sweep's wall time on stderr.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import numpy as np
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent.parent
sys.path.insert(0, str(REPO))

from airjax_torch import golden, pipeline  # noqa: E402
from airjax_torch.config import PipelineConfig  # noqa: E402
from airjax_torch.io import synth  # noqa: E402
from airjax_torch.pipeline import decode_capture_parity  # noqa: E402
from airjax_torch.protocol import shortframe  # noqa: E402

SNRS_DB = (0.0, 2.0, 4.0, 6.0, 8.0, 10.0, 14.0, 20.0)


class SweepMismatch(AssertionError):
    """A check of the sweep failed: the golden curve, or recover2's."""


def _require(cond: bool, what) -> None:
    if not cond:
        raise SweepMismatch(what)


def _decode_regrow(decode, iq: np.ndarray, device) -> tuple[dict, int]:
    """decode(iq, n_off, capacity) over the whole capture, from capacity
    512, x4 on overflow up to n_off (airjax's regrow: a silent truncation
    must not read as a rate difference) -> (host dict, regrows)."""
    block = torch.as_tensor(iq, device=device)
    n_off = len(iq) - 240
    capacity = 512
    out = pipeline.to_host(decode(block, n_off, capacity))
    regrows = 0
    while bool(out["overflow"]) and capacity < n_off:
        capacity = min(capacity * 4, n_off)
        regrows += 1
        out = pipeline.to_host(decode(block, n_off, capacity))
    return out, regrows


def sweep(
    snrs_db=SNRS_DB,
    captures_per_snr: int = 8,
    frames_per_capture: int = 8,
    capture_len: int = 24001,
    check_golden: bool = False,
    recover2: bool = False,
    seed: int = 0,
    *,
    device: torch.device | str = "cuda",
) -> dict:
    """The DF17 curve (airjax tools/snr_sweep.py:27-86): per SNR, the
    share of embedded frames decode_capture_parity finds at their offsets."""
    cfg = PipelineConfig(block_len=capture_len - 1)
    frame = synth.make_df17(0x7C6B30, synth.make_id_me("SNRTEST"))
    spacing = (capture_len - 600) // frames_per_capture
    offsets = [300 + i * spacing for i in range(frames_per_capture)]

    curve = []
    for snr in snrs_db:
        decoded = total = golden_decoded = r2_decoded = r2_false_accepts = 0
        for c in range(captures_per_snr):
            iq = synth.modulate([frame] * len(offsets), offsets, capture_len, snr_db=snr,
                                seed=seed * 100003 + int(snr * 10) * 101 + c)
            hits, _ = decode_capture_parity(iq, cfg, device=device)
            got = {h[1] for h in hits if h[2] == frame}
            decoded += len(got & set(offsets))
            total += len(offsets)
            if recover2:
                r2_got, r2_bad = _decode_recover2(iq, frame, device)
                r2_decoded += len(r2_got & set(offsets))
                r2_false_accepts += r2_bad
            if check_golden:
                ggot = {o for _, o, p in golden.decode_capture_playback(iq, chunk=cfg.block_len) if p == frame}
                golden_decoded += len(ggot & set(offsets))
        point = {"snr_db": snr, "decode_rate": round(decoded / total, 4), "frames": total}
        if recover2:
            point["decode_rate_recover2"] = round(r2_decoded / total, 4)
            point["recover2_false_accepts"] = r2_false_accepts
            # The gated 2-flip repair must be a pure gain: at least the
            # standard rate, and never a wrong frame emitted.
            _require(point["decode_rate_recover2"] >= point["decode_rate"], point)
            _require(r2_false_accepts == 0, point)
        if check_golden:
            point["golden_decode_rate"] = round(golden_decoded / total, 4)
            _require(point["golden_decode_rate"] == point["decode_rate"],
                     f"the device decode diverged from the golden decoder at {snr} dB")
        curve.append(point)
    return {"curve": curve, "frames_per_capture": frames_per_capture}


def _decode_recover2(iq: np.ndarray, true_frame: bytes, device) -> tuple[set, int]:
    """The whole capture through decode_iq_block_r2, gated as the stream
    runner gates a recovered2 frame (its ICAO seen before in a clean or
    1-flip frame) -> (accepted offsets of the true frame, accepted
    recovered2 frames whose bytes are not it: the false accepts)
    (airjax tools/snr_sweep.py:89-134)."""
    out, _ = _decode_regrow(pipeline.decode_iq_block_r2, iq, device)
    seen: set[int] = set()
    got: set[int] = set()
    bad = 0
    for k in np.argsort(out["offsets"], kind="stable"):
        if not out["good"][k]:
            continue
        fb = out["frames"][k].tobytes()
        icao = int.from_bytes(fb[1:4], "big")
        if bool(out["recovered2"][k]):
            if icao not in seen:
                continue
        else:
            seen.add(icao)
        if fb == true_frame:
            got.add(int(out["offsets"][k]))
        elif bool(out["recovered2"][k]):
            # Only a gated 2-flip repair with wrong bytes is recover2's
            # false accept; a CRC or 1-flip noise alias is the standard
            # path's too.
            bad += 1
    return got, bad


def sweep_extended(
    snrs_db=SNRS_DB,
    captures_per_snr: int = 8,
    capture_len: int = 24001,
    check_golden: bool = False,
    seed: int = 0,
    *,
    device: torch.device | str = "cuda",
) -> dict:
    """The extended curves (airjax tools/snr_sweep.py:137-239): per SNR and
    per kind, the share of 2 DF17 (CRC-validated long), 2 DF11 (PI ==
    CRC) and 2 DF4 (the recovered address the transmitter's) a capture
    that decode_iq_block_extended accepts at their offsets; the
    candidate capacity regrown as airjax does, the regrows counted. With
    check_golden, golden.decode_chunk_extended must agree on every count."""
    icao = 0x7C6B30
    df17 = synth.make_df17(icao, synth.make_id_me("SNREXT"))
    df11 = shortframe.make_df11(icao)
    df4 = shortframe.make_df4(icao, 12000)
    frames = [df17, df11, df4, df17, df11, df4]
    spacing = (capture_len - 600) // len(frames)
    offsets = [300 + i * spacing for i in range(len(frames))]
    kinds = ("df17", "df11", "df4")

    curve = []
    for snr in snrs_db:
        got = dict.fromkeys(kinds, 0)
        golden_got = dict.fromkeys(kinds, 0)
        per_kind_total = 2 * captures_per_snr
        regrows = 0
        for c in range(captures_per_snr):
            iq = synth.modulate(frames, offsets, capture_len, snr_db=snr, seed=seed * 90001 + int(snr * 10) * 31 + c)
            out, n = _decode_regrow(pipeline.decode_iq_block_extended, iq, device)
            regrows += n
            for i, off in enumerate(offsets):
                k = np.nonzero(out["offsets"] == off)[0]
                if not len(k):
                    continue
                k = k[0]
                kind = kinds[i % 3]
                ok = (bool(out["good_long"][k]) if kind == "df17"
                      else bool(out["good_df11"][k]) if kind == "df11"
                      else bool(out["cand_short_ap"][k]) and int(out["icao_ap_short"][k]) == icao)
                got[kind] += ok
            if check_golden:
                ghits = {(o, kd): ap for o, kd, _, ap in golden.decode_chunk_extended(iq)}
                for i, off in enumerate(offsets):
                    kind = kinds[i % 3]
                    golden_got[kind] += (off, "long") in ghits if kind == "df17" else (
                        (off, "df11") in ghits if kind == "df11" else ghits.get((off, "short_ap")) == icao)
        point = {"snr_db": snr, **{f"decode_rate_{k}": round(v / per_kind_total, 4) for k, v in got.items()},
                 "capacity_regrows": regrows}
        if check_golden:
            for k in kinds:
                point[f"golden_decode_rate_{k}"] = round(golden_got[k] / per_kind_total, 4)
                _require(golden_got[k] == got[k], f"the extended decode diverged from the golden decoder ({k} at "
                                                  f"{snr} dB: device {got[k]} against golden {golden_got[k]})")
        curve.append(point)
    return {"curve": curve, "frames_per_kind_per_capture": 2}


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--captures", type=int, default=8, help="captures per SNR (8 SNRs)")
    p.add_argument("--frames", type=int, default=8)
    p.add_argument("--golden", action="store_true", help="hold the curve to the golden scalar decoder")
    p.add_argument("--extended", action="store_true", help="per-DF-kind curves")
    p.add_argument("--recover2", action="store_true",
                   help="add the gated 2-bit CRC repair's rate (decode_rate_recover2; at least the standard "
                        "rate, no false accept)")
    p.add_argument("--json", default=None)
    p.add_argument("--torch-device", choices=["cuda", "cpu"], default="cuda",
                   help="where the decode runs (default cuda; raises without a card)")
    args = p.parse_args(argv)
    t0 = time.perf_counter()
    try:
        if args.extended:
            if args.frames != 8:
                print("warning: --frames ignored in --extended mode (fixed 2xDF17+2xDF11+2xDF4 layout)",
                      file=sys.stderr)
            result = sweep_extended(captures_per_snr=args.captures, check_golden=args.golden,
                                    device=args.torch_device)
        else:
            result = sweep(captures_per_snr=args.captures, frames_per_capture=args.frames,
                           check_golden=args.golden, recover2=args.recover2, device=args.torch_device)
    except SweepMismatch as e:
        print(f"snr_sweep: FAILED: {e}", file=sys.stderr)
        return 1
    text = json.dumps(result, indent=2)
    print(text, flush=True)
    if args.json:
        with open(args.json, "w") as f:
            f.write(text)
    n = len(result["curve"]) * args.captures
    print(f"snr_sweep: {n} captures in {time.perf_counter() - t0:.3f} s on {args.torch_device}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
