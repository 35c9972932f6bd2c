"""The port's measuring harness on the CPU: airjax_torch/bench.py against
bench.py (its contract, its workload, its pass against airjax's on
airjax's own blocks, the script's one line, no fallback without a card),
and airjax_torch/graft_entry.py against __graft_entry__.py. Counts are
integers: the tolerance is exact equality."""

import ast
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from airjax.dsp.magnitude import magnitude_u16 as jax_magnitude_u16
from airjax.io import synth as jax_synth
from airjax.pipeline import decode_mags_block as jax_decode_mags_block
from airjax_torch import bench, graft_entry
from airjax_torch.dsp.demod import WINDOW
from airjax_torch.io import synth
from airjax_torch.pipeline import decode_iq_block
from torch_parity import assert_same_dict

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import __graft_entry__ as jax_graft  # noqa: E402
import bench as jax_bench  # noqa: E402

SMALL = {"block_len": 1 << 15, "n_blocks": 2, "capacity": 128, "r_small": 1, "r_big": 3}
SMALL_ARGV = ["--block-len", "32768", "--n-blocks", "2", "--capacity", "128", "--r-small", "1", "--r-big", "3"]
# A run with no card to see, whatever the machine.
NO_CARD = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}


def _bench_py_detail_keys() -> set[str]:
    """The keys of bench.py's `detail` dict, read from its source."""
    for node in ast.walk(ast.parse((REPO / "bench.py").read_text())):
        if isinstance(node, ast.Dict):
            keys = [k.value for k in node.keys if isinstance(k, ast.Constant)]
            if "detail" in keys:
                return {k.value for k in node.values[keys.index("detail")].keys}
    raise AssertionError("bench.py has no detail dict")


def test_bench_contract_small_cpu():
    """test_driver_contract.py::test_bench_small_cpu's assertions, on the
    port, and bench.py's keys."""
    result = bench.bench(**SMALL, device="cpu")
    assert result["metric"] == "iq_throughput_msps"
    assert result["unit"] == "Msamples/s"
    assert result["value"] > 0
    assert abs(result["vs_baseline"] - result["value"] / 2.0) < 0.1
    json.dumps(result)  # serializable
    assert result["detail"]["frames_decoded_per_pass"] >= 1
    assert set(result) == {"metric", "value", "unit", "vs_baseline", "detail"}
    assert set(result["detail"]) == _bench_py_detail_keys() | {"power_limit_w", "eager_seconds_per_pass"}
    assert result["detail"]["device"] == "cpu" and result["detail"]["power_limit_w"] is None


def _modulate_calls(monkeypatch, module) -> list[tuple]:
    """Record each modulate_device call of `module` (frames, offsets,
    total length, noise, seed) and return its capture without noise."""
    calls = []
    real = module.modulate_device

    def recorded(frames, offsets, total_len, amplitude=10000.0, noise_std=60.0, seed=0, **kw):
        calls.append((list(frames), list(offsets), total_len, noise_std, seed))
        return real(frames, offsets, total_len, amplitude, 0.0, seed, **kw)

    monkeypatch.setattr(module, "modulate_device", recorded)
    return calls


@pytest.mark.parametrize("block_len, n_blocks, seed", [(1 << 15, 2, 0), (1 << 16, 1, 3), (40000, 3, 7)])
def test_workload_equals_bench_py(block_len, n_blocks, seed, monkeypatch):
    ours = _modulate_calls(monkeypatch, synth)
    theirs = _modulate_calls(monkeypatch, jax_synth)
    blocks, n_frames = bench.build_workload(block_len, n_blocks, seed, device="cpu")
    jax_blocks, jax_frames = jax_bench.build_workload(block_len, n_blocks, seed)
    assert ours == theirs and len(ours) == 1
    assert n_frames == jax_frames == len(ours[0][1])
    assert [tuple(b.shape) for b in blocks] == [b.shape for b in jax_blocks]
    for block, jax_block in zip(blocks, jax_blocks):  # noise 0: the captures equal airjax's
        np.testing.assert_array_equal(block.numpy(), np.asarray(jax_block))


@pytest.fixture(scope="module")
def jax_workload():
    """airjax's own bench workload (bench.py's build_workload), as numpy."""
    blocks, _ = jax_bench.build_workload(SMALL["block_len"], SMALL["n_blocks"])
    return [np.array(b) for b in blocks]


@pytest.mark.parametrize("capacity", [SMALL["capacity"], 4])
@pytest.mark.parametrize("index", [0, 1])
def test_pass_equals_airjax(jax_workload, index, capacity):
    """The port's pass on airjax's block: n_good and n_detections equal
    decode_mags_block(magnitude_u16(iq)) (capacity 4 overflows)."""
    iq = jax_workload[index]
    n_off = SMALL["block_len"] - WINDOW
    want = jax_decode_mags_block(jax_magnitude_u16(jnp.asarray(iq)), n_off, capacity)
    got = decode_iq_block(torch.from_numpy(iq), n_off, capacity)
    assert int(got["n_good"]) == int(want["n_good"]) >= 1
    assert int(got["n_detections"]) == int(want["n_detections"])
    assert bool(got["overflow"]) == bool(want["overflow"]) == (capacity < int(want["n_detections"]))


def test_repeat_step_sums_every_pass(jax_workload):
    """step(blocks, reps, acc): pass r on blocks[r % n], acc set by the
    first pass and added to by the others, so that a rerun starts from 0."""
    blocks = tuple(torch.from_numpy(b) for b in jax_workload)
    step = bench.make_repeat_step(SMALL["block_len"], SMALL["capacity"])
    n_off = SMALL["block_len"] - WINDOW
    counts = [bench.df17_body(b, n_off, SMALL["capacity"]) for b in blocks]
    acc = torch.full((2,), 12345, dtype=torch.int64)
    for reps in (3, 3, 1):
        want = [sum(int(counts[r % 2][i]) for r in range(reps)) for i in (0, 1)]
        assert step(blocks, reps, acc).tolist() == want


def test_measure_on_cpu_counts_r_big_passes(jax_workload):
    blocks = tuple(torch.from_numpy(b) for b in jax_workload)
    step = bench.make_repeat_step(SMALL["block_len"], SMALL["capacity"])
    timing = bench.measure(step, blocks, 1, 3)
    acc = torch.zeros(2, dtype=torch.int64)
    assert timing["sums"] == tuple(step(blocks, 3, acc).tolist())
    assert timing["seconds_per_pass"] > 0 and timing["fixed_overhead_s"] == 0.0
    with pytest.raises(ValueError, match="r_small < r_big"):
        bench.measure(step, blocks, 3, 3)


def _run(module: str, *argv: str, env=None) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-m", module, *argv], capture_output=True, text=True, timeout=300,
                          cwd=REPO, env=env)


def test_script_prints_one_json_line():
    proc = _run("airjax_torch.bench", "--torch-device", "cpu", *SMALL_ARGV)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert len(lines) == 1
    result = json.loads(lines[0])
    assert set(result) == {"metric", "value", "unit", "vs_baseline", "detail"}
    assert _bench_py_detail_keys() <= set(result["detail"]) and result["value"] > 0


def test_script_traces_and_keeps_its_line(tmp_path):
    proc = _run("airjax_torch.bench", "--trace", str(tmp_path), "--torch-device", "cpu", *SMALL_ARGV)
    assert proc.returncode == 0, proc.stderr
    assert len(proc.stdout.splitlines()) == 1 and json.loads(proc.stdout)["value"] > 0
    assert list(tmp_path.glob("airjax_torch.*.pt.trace.json"))


@pytest.mark.parametrize("argv", [[], ["--torch-device", "cuda"]])
def test_no_fallback_without_a_card(argv):
    """Without a card it prints bench.py's error line and exits nonzero; it
    never runs on the CPU unasked."""
    proc = _run("airjax_torch.bench", *argv, *SMALL_ARGV, env=NO_CARD)
    assert proc.returncode != 0
    (line,) = proc.stdout.splitlines()
    result = json.loads(line)
    assert result["value"] == 0 and result["metric"] == "iq_throughput_msps" and "no CUDA card" in result["error"]


def test_bench_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        bench.bench(**SMALL)


def test_graft_entry_equals_airjax():
    """entry(device="cpu")'s step equals airjax's entry() step key for key
    on a modulated 20,000-sample block, and on its own example."""
    fn, (example,) = graft_entry.entry(device="cpu")
    jax_fn, (jax_example,) = jax_graft.entry()
    assert tuple(example.shape) == jax_example.shape and example.dtype == torch.int16
    frames = [synth.make_df17(0x7C6B30 + i, synth.make_id_me(f"GRAFT{i:02d}")) for i in range(6)]
    iq = jax_synth.modulate(frames, [100 + 3000 * i for i in range(6)], 20000, seed=5)
    jitted = jax.jit(jax_fn)
    for block in (iq, np.array(jax_example)):
        out = fn(torch.from_numpy(block))
        assert_same_dict(jitted(jnp.asarray(block)), out)
        assert out["frames"].shape[-1] == 14
        assert out["offsets"].shape == out["good"].shape
    assert int(fn(torch.from_numpy(iq))["n_good"]) == len(frames)


@pytest.mark.parametrize("n", [1, 2])
def test_graft_dryrun_on_cpu_shards(n, capsys):
    graft_entry.dryrun_multichip(n, device="cpu")
    assert capsys.readouterr().out.startswith(f"dryrun_multichip ok: {n} shards")


def test_graft_entry_script():
    proc = _run("airjax_torch.graft_entry", "--torch-device", "cpu")
    assert proc.returncode == 0, proc.stderr
    first, second = proc.stdout.splitlines()[:2]
    assert first.startswith("entry ok: {'offsets': (256,)") and "'frames': (256, 14)" in first
    assert second.startswith("dryrun_multichip ok: 1 shards")
    proc = _run("airjax_torch.graft_entry", env=NO_CARD)
    assert proc.returncode != 0 and "entry ok" not in proc.stdout
