"""airjax_torch.observability against airjax's (tests/test_observability.py):
`trace` writes a torch.profiler trace (a Chrome trace) on the CPU, and
nothing when disabled; `adsb --trace DIR` writes one; `log_stats` emits
airjax's line; the stream's stats carry the stage timings; each adsb mode
logs its final stats as airjax's does."""

import contextlib
import io
import json
import logging
import os
import time

import numpy as np
import torch

from airjax import observability as jobservability
from airjax_torch import cli, observability
from airjax_torch.io import synth
from airjax_torch.runner import run_stream


def _traces(log_dir) -> list[str]:
    return [os.path.join(root, f) for root, _, files in os.walk(log_dir) for f in files]


def test_trace_writes_a_chrome_trace(tmp_path):
    log_dir = str(tmp_path / "trace")
    with observability.trace(log_dir):
        torch.arange(1 << 12).sum()
    (path,) = _traces(log_dir)
    assert path.endswith(".pt.trace.json")
    events = json.load(open(path))["traceEvents"]
    assert any("aten::sum" in e.get("name", "") for e in events)


def test_trace_disabled_is_noop(tmp_path):
    log_dir = str(tmp_path / "no_trace")
    with observability.trace(log_dir, enabled=False):
        pass
    assert not os.path.exists(log_dir)


def test_log_stats_emits_airjax_line(caplog):
    stats = {"good": 3, "msps": 1.5, "stages": {"fetch": {"calls": 2}}}
    with caplog.at_level(logging.INFO):
        observability.log_stats("bench_done", stats)
        jobservability.log_stats("bench_done", stats)
    got, want = [(r.name, r.levelno, r.getMessage()) for r in caplog.records if "bench_done" in r.getMessage()]
    assert (got[0], want[0]) == ("airjax_torch", "airjax") and got[1:] == want[1:]
    assert '"good": 3' in got[2]


def test_stage_timer_equals_airjax():
    t, j = observability.StageTimer(), jobservability.StageTimer()
    for timer in (t, j):
        with timer.stage("a"):
            time.sleep(0.001)
        timer.add("b", 0.5)
    assert t.as_dict()["b"] == j.as_dict()["b"] == {"total_s": 0.5, "calls": 1, "mean_ms": 500.0}
    assert t.as_dict()["a"]["calls"] == j.as_dict()["a"]["calls"] == 1


def test_run_stream_stats_carry_stage_timings():
    frames = [synth.make_df17(0x7C6B30, synth.make_id_me("OBSTEST"))]
    stats = run_stream(iter([synth.modulate(frames, [500], 30000, seed=21)]), lambda p: None, device="cpu")
    stages = stats.as_dict()["stages"]
    assert set(stages) == {"source", "handoff", "carry", "dispatch", "hold", "fetch", "apply", "sink"}
    assert stages["source"]["calls"] == stages["handoff"]["calls"] == stages["carry"]["calls"] == 1
    assert stages["hold"]["calls"] == stages["fetch"]["calls"] == stages["apply"]["calls"] == stages["sink"]["calls"]
    assert stages["dispatch"]["calls"] == stages["fetch"]["calls"] >= 1
    # The account: the main thread's disjoint stages fit in the run's time,
    # and the sink's calls lie inside apply.
    main = ("source", "carry", "dispatch", "fetch", "apply")
    assert sum(stages[k]["total_s"] for k in main) <= time.time() - stats.started + 1e-3
    assert stages["sink"]["total_s"] <= stages["apply"]["total_s"]


def test_cli_adsb_trace_flag_and_stats_line(tmp_path, monkeypatch, caplog):
    monkeypatch.chdir(tmp_path)
    out = io.StringIO()
    with caplog.at_level(logging.INFO, logger="airjax_torch"), contextlib.redirect_stdout(out):
        rc = cli.main(["adsb", "--synthetic", "2", "-m", "stream", "--trace", "prof", "--torch-device", "cpu"])
    assert rc == 0 and "stats:" in out.getvalue() and "'stages':" in out.getvalue()
    (path,) = _traces("prof")
    names = {e.get("name", "") for e in json.load(open(path))["traceEvents"]}
    assert any(n.startswith("aten::") for n in names)
    done = [r.getMessage() for r in caplog.records if r.getMessage().startswith("adsb_stream_done ")]
    assert len(done) == 1 and json.loads(done[0].split(" ", 1)[1])["blocks"] == 2
    assert np.isfinite(json.loads(done[0].split(" ", 1)[1])["msamples_per_s"])
