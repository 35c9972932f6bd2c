"""A small copy of the benchmark for the CPU: the repository's
BENCHMARK.json and adsbench/ with small cells on a half-second sky of a
few aircraft, driven through the program's plain CPU path."""

from __future__ import annotations

import json
import shutil
import sys
import time
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

SMALL_SKY = {"aircraft": 40, "capture_seconds": 0.5}
SMALL_CELLS = {
    "web-df17.small.fast": ("web-df17", "small.fast"),
    "web-extended.small.fast": ("web-extended", "small.fast"),
    "web-df17.small.live": ("web-df17", "small.live"),
    "web-extended.small.live": ("web-extended", "small.live"),
}
# The closed drive's rate, for the small closed cells: a closed drive
# runs the window fastest, and no cell of BENCHMARK.json has one.
CLOSED_RATE = {"name": "stream_msps", "unit": "MS/s", "better": "higher", "bound": 0.25, "source": "host_clock"}


def make_small_copy(root: Path) -> Path:
    """The benchmark under `root`, with small cells added as new entries
    and new traffic files: the busy sky cut to a few aircraft, driven open
    (`small.live`) and closed (`small.fast`)."""
    root.mkdir(parents=True, exist_ok=True)
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(REPO / "adsbench", root / "adsbench", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    mix = json.loads((REPO / "adsbench" / "traffic" / "busy.live.json").read_text())
    mix["sky"].update(SMALL_SKY)
    (root / "adsbench" / "traffic" / "small.live.json").write_text(json.dumps(mix))
    mix["drive"] = {"loop": "closed"}
    (root / "adsbench" / "traffic" / "small.fast.json").write_text(json.dumps(mix))
    live = [name for name in SMALL_CELLS if name.endswith(".live")]
    spec["end_to_end"].insert(0, dict(CLOSED_RATE, workloads=[n for n in SMALL_CELLS if n not in live]))
    for name, (config, traffic) in SMALL_CELLS.items():
        spec["workloads"].append({"name": name, "config": config, "traffic": traffic, "chips": 1, "why": "CPU tests"})
    for metric in spec["end_to_end"][1:] + spec["per_layer"]:
        if any(w.endswith(".live") for w in metric.get("workloads", ())):
            metric["workloads"] += live
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=2))
    return root


@pytest.fixture(scope="session")
def small_bench(tmp_path_factory):
    from adsbench import harness

    return harness.Bench(make_small_copy(tmp_path_factory.mktemp("adsbench_small")))


def run_small(bench, cell: str, seed: int = 2**33 + 7, seconds: float = 0.6, **kw) -> dict:
    from adsbench import harness

    return harness.run_cell(bench, cell, seed, seconds, False, "cpu", time.perf_counter(), **kw)
