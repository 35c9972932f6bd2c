"""Whole runs of small cells on the CPU, through the program's plain path:
a sound run is correct; the control (the program's parity scan) and each
fault planted under the timed path are not; a cell, a traffic mix and a
metric added as files are found by name; the result line's keys."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from adsbench.tests.conftest import REPO, make_small_copy, run_small

FLAGS_EXT = ("good_long", "good_df11", "cand_df11_ic", "cand_short_ap", "cand_long_ap")


def flagged(out: dict) -> np.ndarray:
    keys = ("good",) if "good" in out else FLAGS_EXT
    return np.nonzero(np.any([np.asarray(out[k]).astype(bool) for k in keys], axis=0))[0]


def state_unchanged(fetch):
    """Every decode after the first returns the first one's dict."""
    first = {}

    def broken(self, slot):
        out = fetch(self, slot)
        return first.setdefault("out", out)

    return broken


def half_left_out(fetch):
    """Every second flagged row of a block's dict dropped."""

    def broken(self, slot):
        out = dict(fetch(self, slot))
        drop = flagged(out)[::2]
        for key in ("good", *FLAGS_EXT):
            if key in out:
                out[key] = np.array(out[key], copy=True)
                out[key][drop] = False
        return out

    return broken


def answer_altered(fetch):
    """One bit of each block's first flagged frame flipped where it is produced."""

    def broken(self, slot):
        out = dict(fetch(self, slot))
        rows = flagged(out)
        if len(rows):
            for key in ("frames", "frames_raw"):
                if key in out:
                    out[key] = np.array(out[key], copy=True)
                    out[key][rows[0], 6] ^= 0x10
        return out

    return broken


def field_altered(group: str, key: str, step: int):
    """One column of the fields the card extracted moved by `step` in every
    row: what the batched tracker reads for altitudes, squawks and speeds."""

    def fault(fetch):
        def broken(self, slot):
            out = dict(fetch(self, slot))
            if out.get(group) is not None and key in out[group]:
                out[group] = dict(out[group])
                col = np.array(out[group][key], copy=True)
                col[col != 0] += step
                out[group][key] = col
            return out

        return broken

    fault.__name__ = f"{group}.{key}"
    return fault


FIELD_FAULTS = [field_altered("fields", "altitude_ft", 25), field_altered("fields", "vel_val_a", 1),
                field_altered("short_fields", "altitude_ft", 25), field_altered("short_fields", "squawk", 1)]


CELLS = ["web-df17.small.fast", "web-extended.small.fast", "web-df17.small.live", "web-extended.small.live"]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(small_bench, cell):
    r = run_small(small_bench, cell)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 50 and r["failed"] == 0
    metrics = {m["name"] for m in small_bench.metrics(cell, False)}
    assert set(r["metrics"]) == metrics


@pytest.mark.parametrize("cell", CELLS[:2])
def test_control_is_not_correct(small_bench, cell):
    r = run_small(small_bench, cell, seconds=1.0, decode_overrides={"overlap": False})
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("fault", [state_unchanged, half_left_out, answer_altered])
@pytest.mark.parametrize("cell", CELLS[:2])
def test_fault_is_not_correct(small_bench, cell, fault, monkeypatch):
    from airjax_torch import pipeline

    monkeypatch.setattr(pipeline.GraphRing, "fetch", fault(pipeline.GraphRing.fetch))
    r = run_small(small_bench, cell)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("fault", FIELD_FAULTS, ids=lambda f: f.__name__)
def test_field_fault_is_not_correct(small_bench, fault, monkeypatch):
    """A field the card got wrong reaches the table, and the table's
    comparison catches it."""
    from airjax_torch import pipeline

    monkeypatch.setattr(pipeline.GraphRing, "fetch", fault(pipeline.GraphRing.fetch))
    # Long enough to replay the whole small capture, with its few DF5s,
    # on a slow host too.
    r = run_small(small_bench, "web-extended.small.fast", seconds=3.0)
    assert r["checks"]["table_failed"]["value"] > 0 and not r["correct"], r["checks"]


def test_new_files_are_found_by_name(tmp_path):
    """A configuration, a traffic mix and a metric reader added as new
    files, with entries in BENCHMARK.json and no file edited, run."""
    from adsbench import harness

    root = make_small_copy(tmp_path / "copy")
    before = {p: p.read_bytes() for p in (root / "adsbench").rglob("*") if p.is_file()}
    spec = json.loads((root / "BENCHMARK.json").read_text())
    config = json.loads((root / "adsbench/configs/web-df17.json").read_text())
    config["decode"]["pipeline_depth"] = 0
    (root / "adsbench/configs/web-df17-depth0.json").write_text(json.dumps(config))
    mix = json.loads((root / "adsbench/traffic/small.fast.json").read_text())
    mix["sky"]["aircraft"] = 12
    (root / "adsbench/traffic/sparse.fast.json").write_text(json.dumps(mix))
    (root / "adsbench/metrics/blocks_a_s.py").write_text("def read(run):\n    return run.blocks / run.window_s\n")
    spec["configs"].append({"name": "web-df17-depth0", "source": "x", "file": "adsbench/configs/web-df17-depth0.json",
                            "reduced": [], "why": "x"})
    spec["workloads"].append({"name": "web-df17-depth0.sparse.fast", "config": "web-df17-depth0",
                              "traffic": "sparse.fast", "chips": 1, "why": "x"})
    spec["end_to_end"][0]["workloads"].append("web-df17-depth0.sparse.fast")
    spec["per_layer"].append({"name": "blocks_a_s", "unit": "1/s", "better": "higher", "source": "host_clock",
                              "layer": "runner", "moves": "stream_msps", "workloads": ["web-df17-depth0.sparse.fast"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    bench = harness.Bench(root)
    assert [m["name"] for m in bench.metrics("web-df17-depth0.sparse.fast", True)] == ["blocks_a_s"]
    r = run_small(bench, "web-df17-depth0.sparse.fast")
    assert r["correct"] and "stream_msps" in r["metrics"]
    for path, data in before.items():
        assert path.read_bytes() == data, path


SECOND_ENTRY = """
from adsbench.entries import stream


class Entry(stream.Entry):
    \"\"\"The stream with its source re-chunked into blocks of a quarter
    of the configuration's, as a receiver with a small USB buffer reads.\"\"\"

    def __init__(self, config, decode, device):
        super().__init__(config, decode, device)
        self.block //= 4

    def run(self, drive, sink):
        def quarters():
            for block in drive:
                q = len(block) // 4
                for i in range(4):
                    yield block[i * q : (i + 1) * q]

        self.runner.run_stream(quarters(), sink, overlap=self.overlap, stats=self.stats,
                               extended=self.extended, pipeline_depth=self.depth,
                               recover2=bool(self.decode["recover2"]), device=self.device)

    def log(self):
        return "quarters; " + super().log()
"""


def test_new_entry_is_found_by_name(tmp_path):
    """A second entry, added as a file and named by a new configuration,
    drives the window with no file edited."""
    from adsbench import harness

    root = make_small_copy(tmp_path / "copy")
    before = {p: p.read_bytes() for p in (root / "adsbench").rglob("*") if p.is_file()}
    (root / "adsbench/entries/quarters.py").write_text(SECOND_ENTRY)
    config = json.loads((root / "adsbench/configs/web-df17.json").read_text())
    config["entry"] = "quarters"
    config["receiver"]["block_samples"] = 100000
    (root / "adsbench/configs/web-df17-quarters.json").write_text(json.dumps(config))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "web-df17-quarters", "source": "x",
                            "file": "adsbench/configs/web-df17-quarters.json", "reduced": [], "why": "x"})
    spec["workloads"].append({"name": "web-df17-quarters.small.fast", "config": "web-df17-quarters",
                              "traffic": "small.fast", "chips": 1, "why": "x"})
    spec["end_to_end"][0]["workloads"].append("web-df17-quarters.small.fast")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    r = run_small(harness.Bench(root), "web-df17-quarters.small.fast")
    assert r["correct"], r["checks"]
    assert r["log"][0].startswith("quarters; ")
    for path, data in before.items():
        assert path.read_bytes() == data, path


def test_result_line_keys():
    from adsbench import harness

    numbers = {"frames_failed": 0, "table_failed": 0}
    facts = {"attempted": 3, "failed": 0}
    dev = {"platform": "gpu", "kind": "x", "count": 1, "memory_peak_bytes": 1}
    line = harness.result_line(numbers, facts, {}, dev, None)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    summary = {"device_ops": [["k", 1e-3]], "idle_gaps": [["g", 2e-3]]}
    line = harness.result_line(numbers, facts, {}, dev, summary)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "breakdown", "checks"]
    assert line["checks"]["frames_failed"] == {"value": 0, "limit": 0}
    assert not harness.result_line({"frames_failed": 1}, facts, {}, dev, None)["correct"]


def test_no_card_no_result():
    """Without a card the command exits non-zero and prints no result."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, "adsbench/run.py", "--workload", "web-df17.busy.live", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert p.returncode == 2 and p.stdout.strip() == ""


def test_needs_the_program(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files
    cannot run: the program is not there."""
    root = make_small_copy(tmp_path / "alone")
    env = {**os.environ, "PYTHONPATH": ""}
    p = subprocess.run([sys.executable, "adsbench/run.py", "--workload", "web-df17.busy.live", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=root, capture_output=True, text=True, timeout=300,
                       env=env)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "No module named 'airjax_torch'" in p.stderr


@pytest.mark.cuda
def test_cell_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run([sys.executable, "adsbench/run.py", "--workload", "web-df17.busy.live", "--seed",
                        str(2**32 + 5), "--seconds", "2", "--trace", "1"], cwd=REPO, capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["busy_s"] > 0
