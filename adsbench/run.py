"""The benchmark of airjax_torch's stream decode, one cell a run:

    python3 adsbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout on a machine with the cards the cell
asks for. Prints, as the last line of standard output, one JSON object:
correct, attempted, failed, metrics (the cell's end-to-end metrics, or
with --trace 1 its per-layer ones), device, with --trace 1 breakdown,
and last the numbers compared with their limits, which also end standard
error. Exits 2 without a result where the cards are missing, and 3 where
the process holds JAX or the JAX package once the window has closed.
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
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    # Every cache the program or torch builds stays in the checkout.
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    # The profiler detaches CUPTI after its window (the card's exit hang
    # and lost events: the process leaves through os._exit).
    os.environ["TEARDOWN_CUPTI"] = "1"
    # One process, few threads: no idle intra-op pool spinning beside the
    # runner's two threads (the block loop and the source's prefetch).
    os.environ["OMP_NUM_THREADS"] = "1"
    sys.path.insert(0, str(ROOT))
    import airjax_torch  # noqa: F401  the program under test, beside the benchmark
    from adsbench import harness

    bench = harness.Bench(ROOT)
    cell = bench.cell(args.workload)
    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"adsbench: {args.workload} needs {cell['chips']} CUDA card(s), this machine has {n}",
              file=sys.stderr)
        return 2
    result = harness.run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    found = harness.banned_modules()
    if found:
        print(f"adsbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    for line in result.pop("log"):
        print(line, file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception:  # reported, then the same exit as every other path
        import traceback

        traceback.print_exc()
        code = 1
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)
