#!/usr/bin/env python3
"""The cost of the extended decode on the card (tools/bench_extended_tpu.py,
on the port): three variants of one block pass, same shapes, measured one
after another in one run, each by airjax_torch.bench's graph slope.

  python3 airjax_torch/tools/bench_extended.py [--r-small 2] [--r-big 12]
      [--capacity 4096] [--block-len 16777216] [--torch-device cuda|cpu]

  df17        pipeline.decode_iq_block (the front's DF17 gate, the block
              decode's DF17 mode): bench.py's pass
  ext         pipeline.decode_iq_block_extended (the preamble-only gate,
              every downlink format: dual CRC, AP classes)
  ext_fields  pipeline.decode_iq_block_extended_with_fields: the same, the
              block decode with its flag F writing the long and short
              frames' fields in the same launch (what the batched
              extended sink runs)

Each pass accumulates (good_long summed, n_detections); DF17's
(n_good, n_detections). The JAX tool also sums the fields into its
accumulator so that XLA keeps them; CUDA runs every kernel it is given,
so the port adds no reduction to the pass it times. The block is bench.py's
workload (bench.build_workload, 2^24 + 1024 samples), n_off = block - WINDOW.

Prints a line a variant, {name: {s_per_pass, msps, out}}, then the summary
with vs_df17 (df17's seconds over the variant's) and fields_overhead_s
(ext_fields less ext). On the CPU (--torch-device cpu) the times are
medians of eager passes, as airjax_torch.bench's.
"""

from __future__ import annotations

import argparse
import json
import sys

sys.path.insert(0, str(__import__("pathlib").Path(__file__).resolve().parent.parent.parent))

import torch  # noqa: E402

from airjax_torch import bench  # noqa: E402
from airjax_torch.bench import df17_body  # noqa: E402
from airjax_torch.pipeline import (  # noqa: E402
    decode_iq_block_extended,
    decode_iq_block_extended_with_fields,
)

BLOCK = 1 << 24
CAPACITY = 4096  # preamble-only detection fires more often than the DF17 gate on noise


def ext_body(iq, n_off, capacity):
    out = decode_iq_block_extended(iq, n_off, capacity)
    return out["good_long"].sum(dtype=torch.int32), out["n_detections"]


def ext_fields_body(iq, n_off, capacity):
    out = decode_iq_block_extended_with_fields(iq, n_off, capacity)
    return out["good_long"].sum(dtype=torch.int32), out["n_detections"]


VARIANTS = {"df17": df17_body, "ext": ext_body, "ext_fields": ext_fields_body}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--r-small", type=int, default=2)
    ap.add_argument("--r-big", type=int, default=12)
    ap.add_argument("--capacity", type=int, default=CAPACITY,
                    help="candidate capacity; 16384 covers every preamble-only detection at the default noise")
    ap.add_argument("--block-len", type=int, default=BLOCK)
    ap.add_argument("--torch-device", choices=["cuda", "cpu"], default="cuda",
                    help="cuda (default; fails without a card) or the CPU's plain versions")
    args = ap.parse_args(argv)

    device = bench.check_device(args.torch_device)
    blocks, _ = bench.build_workload(args.block_len, 1, device=device)
    print(f"device: {bench.card_label(device)}, block={args.block_len}, n_off={args.block_len - bench.WINDOW}, "
          f"capacity={args.capacity}", flush=True)

    results = {}
    for variant, body in VARIANTS.items():
        step = bench.make_repeat_step(args.block_len, args.capacity, body)
        timing = bench.measure(step, blocks, args.r_small, args.r_big)
        per_pass = timing["seconds_per_pass"]
        results[variant] = {"s_per_pass": per_pass, "msps": args.block_len / per_pass / 1e6,
                            "out": list(timing["sums"])}
        print(json.dumps({variant: results[variant]}), flush=True)

    base = results["df17"]["s_per_pass"]
    for variant in ("ext", "ext_fields"):
        results[variant]["vs_df17"] = base / results[variant]["s_per_pass"]
    results["fields_overhead_s"] = results["ext_fields"]["s_per_pass"] - results["ext"]["s_per_pass"]
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
