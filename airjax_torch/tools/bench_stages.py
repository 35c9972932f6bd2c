#!/usr/bin/env python3
"""The DF17 pass's cost by nested prefixes on the card (tools/bench_stages.py,
on the port), each stage timed by airjax_torch.bench's graph slope.

  python3 airjax_torch/tools/bench_stages.py [--torch-device cuda|cpu]
      [--block-len 16777216] [--capacity 2048] [--r-small 2] [--r-big 12]

  detect   the DF17 gate over n_off offsets, counted: the front's count
           mode (kernels/magdet.py::chunked_detection_count, csrc/front.cu),
           one launch and a sum of its tile counts
  compact  + the candidate compaction: the bits front (magdet_bits,
           csrc/front.cu), then compact_bits (csrc/compact.cu)
  pack     + the packed compares: the same launches as compact
  full     + slicing, CRC and recovery: pipeline.decode_iq_block, the bits
           front and the block decode (csrc/block_decode.cu), the pass of
           airjax_torch/bench.py

compact and pack launch the same kernels on the port: its front writes the
compare words in the pass that writes the detection bits, and it has no mode
that writes the bits alone. airjax's pack adds pack_cmp_words, a pass of its
own; the port's adds only the sum of the first 8 words. So pack less compact
is that small sum, and compact less detect is what the compare words, the
bit store and the compaction cost beside the gate alone.

Each body returns airjax's (a, b) int32 pair: detect (the count, twice),
compact (the compacted offsets summed, n_detections), pack (the first 8
compare words summed plus compact's sum, n_detections), full (n_good,
n_detections). airjax sums in int32 and wraps; the port sums in int64 and
wraps to int32 (wrap_int32, the low word), since an empty slot holds n_off
and K of them pass 2^31. PLAIN holds each stage in plain torch, airjax's own formulation
(magnitude_u16, detect, compact_mask, pack_cmp_words, decode_mags_block),
on either device: the reference that chip_smoke.py holds the bodies to on
the card.

The capture is tools/bench_fused.py's build_iq: block_len + HALO samples,
one DF17 frame per 16,384 on the 300-sample grid, noise 60, through
io/synth.py::modulate_device (bench.py's workload at one block). No
per-pass perturbation: airjax adds the pass index to the IQ only so that
XLA cannot hoist the loop-invariant decode out of its loop; CUDA runs every
kernel it is given, and the add would be a 64 MB kernel of its own in every
pass.

Prints the device, then one JSON line a stage in airjax's order: airjax's
keys {"stage", "seconds_per_pass", "msps"} (unrounded; msps is n_off over
seconds_per_pass), plus eager_seconds_per_pass, device, power_limit_w and
sums (the pair summed over r_big passes). On the CPU (--torch-device cpu)
the kernels' plain versions run and the time is the median of eager passes,
as airjax_torch.bench's. Without a card, and without --torch-device cpu, it
fails (the exit code is nonzero).
"""

from __future__ import annotations

import argparse
import json
import sys

sys.path.insert(0, str(__import__("pathlib").Path(__file__).resolve().parent.parent.parent))

import torch  # noqa: E402

from airjax_torch import bench  # noqa: E402
from airjax_torch.bench import HALO, df17_body as full_body  # noqa: E402,F401
from airjax_torch.dsp.demod import WINDOW, detect, pack_cmp_words  # noqa: E402
from airjax_torch.dsp.magnitude import magnitude_u16  # noqa: E402
from airjax_torch.kernels.compact import compact_bits  # noqa: E402
from airjax_torch.kernels.magdet import chunked_detection_count, magdet_bits  # noqa: E402
from airjax_torch.pipeline import compact_mask, decode_mags_block  # noqa: E402

BLOCK = 1 << 24
CAPACITY = 2048


def build_iq(seed=0, block_len=BLOCK, *, device: torch.device | str = "cuda") -> torch.Tensor:
    """tools/bench_fused.py's capture on `device`: (block_len + HALO, 2)
    int16, bench.build_workload's one block."""
    blocks, _ = bench.build_workload(block_len, 1, seed, device=device)
    return blocks[0]


def wrap_int32(total: torch.Tensor) -> torch.Tensor:
    """An int64 tensor modulo 2^32, as int32 (airjax's int32 sums wrap): the
    low word of each element, a view of the little-endian storage that
    launches no kernel (a small kernel costs 1.5 to 1.9 µs a pass in a
    graph on an H100: PERF.md)."""
    return total.reshape(-1).view(torch.int32)[0::2].reshape(total.shape)


def detect_body(iq, n_off, capacity):
    """The DF17 detections at offsets [0, n_off): one chunk of n_off +
    WINDOW samples in the front's count mode."""
    s = chunked_detection_count(iq, n_off + WINDOW, 1)
    return s, s


def _compacted(iq, n_off, capacity):
    det_words, words, counts = magdet_bits(iq, n_off)
    offsets, _, n_det, _ = compact_bits(det_words, counts, n_off, capacity)
    return offsets.sum(dtype=torch.int64), n_det, words


def compact_body(iq, n_off, capacity):
    offsets_sum, n_det, _ = _compacted(iq, n_off, capacity)
    return wrap_int32(offsets_sum), n_det


def pack_body(iq, n_off, capacity):
    offsets_sum, n_det, words = _compacted(iq, n_off, capacity)
    return wrap_int32(words[:8].sum(dtype=torch.int64) + offsets_sum), n_det


def _detect_plain(iq, n_off, capacity):
    s = detect(magnitude_u16(iq), n_off).sum(dtype=torch.int32)
    return s, s


def _compact_plain(iq, n_off, capacity):
    offsets, n_det = compact_mask(detect(magnitude_u16(iq), n_off), capacity)
    return wrap_int32(offsets.sum(dtype=torch.int64)), n_det


def _pack_plain(iq, n_off, capacity):
    mags = magnitude_u16(iq)
    offsets, n_det = compact_mask(detect(mags, n_off), capacity)
    return wrap_int32(pack_cmp_words(mags)[:8].sum(dtype=torch.int64) + offsets.sum(dtype=torch.int64)), n_det


def _full_plain(iq, n_off, capacity):
    out = decode_mags_block(magnitude_u16(iq), n_off, capacity)
    return out["n_good"], out["n_detections"]


STAGES = {"detect": detect_body, "compact": compact_body, "pack": pack_body, "full": full_body}
PLAIN = {"detect": _detect_plain, "compact": _compact_plain, "pack": _pack_plain, "full": _full_plain}


def measure_stage(stage: str, iq: torch.Tensor, block_len: int, capacity: int, r_small: int, r_big: int,
                  card: tuple[str, float | None]) -> dict:
    """One stage's line: `stage`'s body on iq timed by bench.measure."""
    timing = bench.measure(bench.make_repeat_step(block_len, capacity, STAGES[stage]), (iq,), r_small, r_big)
    per_pass = timing["seconds_per_pass"]
    return {"stage": stage, "seconds_per_pass": per_pass, "msps": (block_len - WINDOW) / per_pass / 1e6,
            "eager_seconds_per_pass": timing["eager_seconds_per_pass"], "device": card[0],
            "power_limit_w": card[1], "sums": list(timing["sums"])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--torch-device", choices=["cuda", "cpu"], default="cuda",
                    help="cuda (default; fails without a card) or the CPU's plain versions")
    ap.add_argument("--block-len", type=int, default=BLOCK)
    ap.add_argument("--capacity", type=int, default=CAPACITY)
    ap.add_argument("--r-small", type=int, default=2)
    ap.add_argument("--r-big", type=int, default=12)
    args = ap.parse_args(argv)

    device = bench.check_device(args.torch_device)
    iq = build_iq(block_len=args.block_len, device=device)
    card = bench.card(device)
    print(f"device: {bench.card_label(device)}, block={args.block_len}, n_off={args.block_len - WINDOW}, "
          f"capacity={args.capacity}", flush=True)
    for stage in STAGES:
        line = measure_stage(stage, iq, args.block_len, args.capacity, args.r_small, args.r_big, card)
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
