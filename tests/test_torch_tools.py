"""The port's tiers of the root tools on the CPU (airjax_torch/tools/): the
two parity fuzzers, the soak in its modes (the live one through the fake
SoapySDR) and the multi-device dry run, each for a few iterations or
seconds, exit 0; each fuzzer exits 1 when a tier's decode is made wrong.
The SNR sweep's curves equal airjax's tools/snr_sweep.py's, point for
point, in its three modes with the golden check; it exits 1 when the
decode loses a frame the golden decoder finds. The measuring tools
(bench_stream, bench_host, bench_extended, scaling_sweep) print the JAX
tools' keys at tiny sizes; bench_host's counts equal tools/bench_host.py's;
bench_stream and scaling_sweep exit 1 when the decode drops a frame."""

import ast
import importlib.util
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from airjax_torch import native, pipeline
from airjax_torch.io import synth
from airjax_torch.io.c16 import save_c16
from airjax_torch.parallel import halo
from airjax_torch.tools import (
    bench_extended,
    bench_host,
    bench_stream,
    dryrun_multichip,
    fuzz_extended,
    fuzz_parity,
    scaling_sweep,
    snr_sweep,
    soak,
)

CPU = ["--torch-device", "cpu"]
REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("argv", [[], ["--chunk", "2000", "--seed", "3"]])
def test_fuzz_parity_agrees(argv):
    assert fuzz_parity.main(["--iters", "10", *argv, *CPU]) == 0


def test_fuzz_parity_exits_1_on_a_wrong_decode(monkeypatch, capsys):
    real = fuzz_parity.decode_capture_parity

    def dropped(*a, **kw):
        hits, stats = real(*a, **kw)
        return hits[1:], stats

    monkeypatch.setattr(fuzz_parity, "decode_capture_parity", dropped)
    assert fuzz_parity.main(["--iters", "10", *CPU]) == 1
    assert "MISMATCH at iteration" in capsys.readouterr().out


@pytest.mark.parametrize("recover2", [False, True])
def test_fuzz_extended_agrees(recover2):
    assert fuzz_extended.main(["--iters", "12", *(["--recover2"] if recover2 else []), *CPU]) == 0


@pytest.mark.parametrize("tier", ["device", "native"])
def test_fuzz_extended_exits_1_on_a_wrong_decode(tier, monkeypatch, capsys):
    if tier == "device":
        real = pipeline.decode_iq_block_extended

        def wrong(*a, **kw):
            out = real(*a, **kw)
            out["offsets"] = out["offsets"] + 1
            return out

        monkeypatch.setattr(pipeline, "decode_iq_block_extended", wrong)
    else:
        monkeypatch.setattr(native, "decode_chunk_extended", lambda iq, max_hits=4096, recover2=False: ([], 0))
    assert fuzz_extended.main(["--iters", "12", *CPU]) == 1
    out = capsys.readouterr().out
    assert "MISMATCH at iteration" in out and f"lens: {tier}=" in out


@pytest.fixture
def fake_sdr(tmp_path, monkeypatch):
    """The fake SoapySDR over a 20,000-sample capture of three frames in its
    interior (soak --sdr's expected layout)."""
    frame = synth.make_df17(0x7C0DEF, synth.make_id_me("SOAKSDR_"))
    path = tmp_path / "fake.c16"
    save_c16(synth.modulate([frame] * 3, [1000, 7000, 13000], 20000, seed=11), path)
    monkeypatch.setenv("AIRJAX_SOAPY_LIB", str(native.build_fake_soapysdr()))
    monkeypatch.setenv("AIRJAX_FAKE_SOAPY_C16", str(path))


@pytest.mark.parametrize("argv", [
    [], ["--pipeline-depth", "0"], ["--pipeline-depth", "2", "--block", "40000"], ["--recover2"], ["--extended"],
    ["--extended", "--recover2"], ["--extended", "--rotate", "5", "--evict", "1", "--memcheck"], ["--devices", "2"],
    ["--extended", "--devices", "2"], ["--sdr"], ["--sdr", "--extended"], ["--sdr", "--devices", "2"],
])
def test_soak_exits_0(argv, fake_sdr, capsys):
    assert soak.main(["--seconds", "1.5", *argv, *CPU]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert '"boundary_loss": 0' in line and '"frames_decoded": 0' not in line


def test_soak_refuses_recover2_with_rotate(capsys):
    assert soak.main(["--seconds", "1", "--extended", "--recover2", "--rotate", "3", *CPU]) == 2


@pytest.mark.parametrize("n", [1, 3])
def test_dryrun_multichip_on_cpu_shards(n, capsys):
    assert dryrun_multichip.main([str(n), *CPU]) == 0
    assert capsys.readouterr().out.startswith(f"dryrun_multichip ok: {n} shards")


def _airjax_tool(name: str):
    """airjax's tools/<name>.py, loaded from its path (tools/ is no
    package)."""
    spec = importlib.util.spec_from_file_location(f"airjax_{name}", REPO / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


SWEEP_SIZE = {"snrs_db": (4.0, 8.0, 14.0), "captures_per_snr": 2, "check_golden": True}


@pytest.mark.parametrize("mode", ["df17", "recover2", "extended"])
def test_snr_sweep_equals_airjax(mode):
    theirs = _airjax_tool("snr_sweep")
    if mode == "extended":
        want = theirs.sweep_extended(**SWEEP_SIZE)
        got = snr_sweep.sweep_extended(**SWEEP_SIZE, device="cpu")
    else:
        kw = {"frames_per_capture": 4, "recover2": mode == "recover2", **SWEEP_SIZE}
        want, got = theirs.sweep(**kw), snr_sweep.sweep(**kw, device="cpu")
    assert got == want
    assert got["curve"][-1] != got["curve"][0]  # the sizes reach both ends of the curve


def test_snr_sweep_exits_1_when_the_decode_loses_a_frame(monkeypatch, capsys):
    real = snr_sweep.decode_capture_parity

    def dropped(*a, **kw):
        hits, stats = real(*a, **kw)
        return hits[1:], stats

    assert snr_sweep.main(["--captures", "1", "--golden", *CPU]) == 0
    assert json.loads(capsys.readouterr().out)["curve"][-1]["golden_decode_rate"] == 1.0
    monkeypatch.setattr(snr_sweep, "decode_capture_parity", dropped)
    assert snr_sweep.main(["--captures", "1", "--golden", *CPU]) == 1
    assert "diverged from the golden decoder" in capsys.readouterr().err


def _drop_first_good(decode):
    """decode with the first good slot of each dict it returns cleared: a
    decode that loses a frame."""

    def dropped(*a, **kw):
        out = dict(decode(*a, **kw))
        good = out["good"].clone()
        hits = torch.nonzero(good).flatten()
        if len(hits):
            good[hits[0]] = False
        out["good"] = good
        return out

    return dropped


STREAM = ["--blocks", "2", "--block-len", str(1 << 21)]  # 2 frames a block


def test_bench_stream_prints_each_depth(capsys):
    assert bench_stream.main([*STREAM, *CPU]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "device: cpu"
    rows = [json.loads(line) for line in lines[1:]]
    assert [r["pipeline_depth"] for r in rows] == [0, 1, 2]
    for row in rows:
        assert set(row) == {"pipeline_depth", "seconds", "msps", "good", "stage_s"}
        assert set(row["stage_s"]) == {"source", "handoff", "carry", "dispatch", "hold", "fetch", "apply", "sink"}
        assert row["good"] == 4 and row["msps"] > 0


def _fetch_dropping_first_good(fetch):
    """pipeline.BlockGraphs.fetch (run_stream's decodes) with the first good
    slot of each dict cleared: a decode that loses a frame."""

    def dropped(self, slot):
        out = fetch(self, slot)
        hits = np.nonzero(out["good"])[0]
        if len(hits):
            out["good"] = out["good"].copy()
            out["good"][hits[0]] = False
        return out

    return dropped


def test_bench_stream_exits_1_on_a_dropped_frame(monkeypatch, capsys):
    monkeypatch.setattr(pipeline.BlockGraphs, "fetch", _fetch_dropping_first_good(pipeline.BlockGraphs.fetch))
    assert bench_stream.main([*STREAM, *CPU]) == 1
    assert "4 frames embedded" in capsys.readouterr().err


HOST_COUNTS = ("messages", "aircraft", "with_geo", "extended_messages", "extended_aircraft", "extended_with_geo")


@pytest.mark.parametrize("messages", [3000])
def test_bench_host_counts_equal_airjax(messages, monkeypatch, capsys):
    theirs = _airjax_tool("bench_host")
    monkeypatch.setattr(sys, "argv", ["bench_host.py", "--messages", str(messages)])
    theirs.main()
    want = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert bench_host.main(["--messages", str(messages), *CPU]) == 0
    got = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert set(got) == set(want)
    assert {k: got[k] for k in HOST_COUNTS} == {k: want[k] for k in HOST_COUNTS}
    assert got["aircraft"] == got["with_geo"] == 64 and got["extended_messages"] > 0


@pytest.mark.parametrize("gap_ms", [0.0, 8.0])
def test_bench_host_sink_times_the_call_and_its_parts(gap_ms, capsys):
    assert bench_host.main(["--sink", "--blocks", "12", "--gap-ms", str(gap_ms), *CPU]) == 0
    line = json.loads(capsys.readouterr().out.splitlines()[-1])
    parts = ("select_ms", "gate_ms", "walk_ms", "cpr_ms", "summaries_ms")
    assert line["blocks"] == 12 and line["gap_ms"] == gap_ms and line["summaries_sent"] > 0 and line["rows_a_block"] > 0
    assert all(line[k] > 0 for k in ("sink_ms", "decode_pairs_us_3", "decode_pairs_us_12", *parts))
    assert 0 <= line["blocks_with_fallback"] <= 1


def test_bench_extended_prints_the_jax_tools_lines(capsys):
    assert bench_extended.main(["--block-len", "32768", "--r-small", "1", "--r-big", "3", *CPU]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("device: cpu")
    variants = [json.loads(line) for line in lines[1:4]]
    assert [list(v) for v in variants] == [["df17"], ["ext"], ["ext_fields"]]
    for variant in variants:
        (row,) = variant.values()
        assert set(row) == {"s_per_pass", "msps", "out"} and row["s_per_pass"] > 0
    summary = json.loads(lines[4])
    assert set(summary) == {"df17", "ext", "ext_fields", "fields_overhead_s"}
    assert "vs_df17" in summary["ext"] and "vs_df17" in summary["ext_fields"]
    # ext and ext_fields decode the same block alike; each of the 3 passes
    # finds the block's 2 frames.
    assert summary["ext"]["out"] == summary["ext_fields"]["out"]
    assert summary["df17"]["out"][0] == summary["ext"]["out"][0] == 3 * 2


def _scaling_row_keys() -> set[str]:
    """The keys of tools/scaling_sweep.py's row, read from its source."""
    for node in ast.walk(ast.parse((REPO / "tools" / "scaling_sweep.py").read_text())):
        if isinstance(node, ast.Dict) and any(isinstance(k, ast.Constant) and k.value == "devices" for k in node.keys):
            return {k.value for k in node.keys}
    raise AssertionError("tools/scaling_sweep.py has no row dict")


SWEEP = ["--per-device", "30000", "--repeats", "2"]


def test_scaling_sweep_rows_decode_every_frame(tmp_path, capsys):
    out = tmp_path / "rows.json"
    assert scaling_sweep.main([*SWEEP, "--json", str(out), *CPU]) == 0
    rows = json.loads(out.read_text())
    assert [json.loads(line) for line in capsys.readouterr().out.splitlines()] == rows
    assert [(r["devices"], r["gather"]) for r in rows] == [(d, g) for d in (1, 2, 4, 8) for g in ("compact", "dense")]
    for row in rows:
        assert set(row) == _scaling_row_keys() | {"one_card"}
        assert row["frames_decoded"] == row["frames_embedded"] == 8 * row["devices"]
        assert row["weak_scaling_efficiency"] is None and row["one_card"] is False  # shards on one CPU
        assert set(row["stage_ms"]) == {"upload", "step", "fetch", "walk"}


def test_scaling_sweep_exits_1_on_a_dropped_frame(monkeypatch, capsys):
    monkeypatch.setattr(halo, "decode_iq_block", _drop_first_good(halo.decode_iq_block))
    assert scaling_sweep.main([*SWEEP, *CPU]) == 1
    assert "other frames than embedded" in capsys.readouterr().err


def test_tools_run_as_scripts():
    """Each tool runs from a checkout by its path, as the README gives it."""
    for argv in (["fuzz_parity.py", "--iters", "2"], ["dryrun_multichip.py", "2"],
                 ["snr_sweep.py", "--captures", "1", "--extended"],
                 ["bench_stream.py", "--blocks", "1", "--block-len", str(1 << 20)],
                 ["bench_host.py", "--messages", "2000"],
                 ["bench_extended.py", "--block-len", "32768", "--r-small", "1", "--r-big", "2"],
                 ["scaling_sweep.py", "--per-device", "20000", "--repeats", "1"]):
        proc = subprocess.run([sys.executable, f"airjax_torch/tools/{argv[0]}", *argv[1:], *CPU],
                              capture_output=True, text=True, timeout=300, cwd=REPO)
        assert proc.returncode == 0, proc.stderr
