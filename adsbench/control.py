"""The control of the comparison that decides `correct`, read on the card:

    python3 adsbench/control.py --seconds 10 --seeds 3 [--workload <cell> ...]

Runs each cell (every cell of BENCHMARK.json by default) with the program's
own parity scan in place of the overlap scan (run_stream(overlap=False):
each block scanned on its own, the frames across a block edge lost), the
step that breaks the configuration's guarantee, over `--seeds` seeds in
one process, and prints a JSON line a run with the numbers compared. The
benchmark's own runs never run it; PERF.md keeps its readings beside the
limits they set.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", action="append")
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=4_100_000_000)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    from adsbench import harness

    bench = harness.Bench(ROOT)
    cells = args.workload or [c["name"] for c in bench.spec["workloads"]]
    for cell in cells:
        for i in range(args.seeds):
            seed = args.first_seed + 7919 * i
            r = harness.run_cell(bench, cell, seed, args.seconds, False, "cuda", T_START,
                                 decode_overrides={"overlap": False})
            print(json.dumps({"workload": cell, "seed": seed, "control": "overlap=False",
                              "correct": r["correct"], "attempted": r["attempted"], "failed": r["failed"],
                              "checks": {k: v["value"] for k, v in r["checks"].items()}}), flush=True)
    return 0


if __name__ == "__main__":
    code = main()
    sys.stdout.flush()
    os._exit(code)
