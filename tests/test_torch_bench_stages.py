"""airjax_torch/tools/bench_stages.py against tools/bench_stages.py on the
CPU: each stage's (a, b) int32 pair through the port's bodies (the
kernels' plain versions on the CPU) and through its PLAIN bodies equals
airjax's body's on the same IQ, exactly (the counts and sums are
integers; airjax's int32 sums wrap, and so must the port's). The capture
is tools/bench_fused.py's, and the tool prints airjax's lines in airjax's
order."""

import ast
import importlib
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

from airjax.io import synth as jax_synth
from airjax_torch.dsp.demod import WINDOW
from airjax_torch.io import synth
from airjax_torch.tools import bench_stages

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

jax_stages = importlib.import_module("tools.bench_stages")  # airjax's; it imports tools.bench_fused
jax_fused = importlib.import_module("tools.bench_fused")

STAGE_ORDER = ["detect", "compact", "pack", "full"]


def _noise(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.clip(np.rint(rng.normal(0.0, 60.0, (n, 2))), -32768, 32767).astype(np.int16)


def _storm(n: int) -> np.ndarray:
    """One magnitude everywhere: every offset passes the gate (>= ties)."""
    return np.tile(np.array([[600, -800]], dtype=np.int16), (n, 1))


# case -> (IQ maker, block length, capacity)
CASES = {
    "bench_fused_capture": (lambda: bench_stages.build_iq(0, 1 << 15, device="cpu").numpy(), 1 << 15, 2048),
    "noise_wraps_int32": (lambda: _noise((1 << 20) + 1024, 15), 1 << 20, 4096),
    "storm_overflows_capacity": (lambda: _storm((1 << 15) + 1024), 1 << 15, 2048),
}
_IQ: dict[str, np.ndarray] = {}


def _jax_body(stage: str):
    return jax.jit(getattr(jax_stages, f"{stage}_body"), static_argnums=(1, 2))


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("stage", STAGE_ORDER)
def test_body_equals_airjax(stage, case):
    make, block_len, capacity = CASES[case]
    iq = _IQ.setdefault(case, make())
    n_off = block_len - WINDOW
    want = tuple(int(x) for x in _jax_body(stage)(jnp.asarray(iq), n_off, capacity))
    got = tuple(int(x) for x in bench_stages.STAGES[stage](torch.from_numpy(iq), n_off, capacity))
    plain = tuple(int(x) for x in bench_stages.PLAIN[stage](torch.from_numpy(iq), n_off, capacity))
    assert got == plain == want
    a, n_det = want
    if case == "noise_wraps_int32" and stage == "compact":
        assert n_det < capacity and a < 0  # the empty slots' n_off passed 2^31 and wrapped
    if case == "storm_overflows_capacity" and stage != "detect":
        assert n_det == n_off > capacity
    if case == "bench_fused_capture" and stage == "full":
        assert a == 2 and n_det >= 2  # the capture's two frames


@pytest.mark.parametrize("shape", [(), (3,), (2, 2)])
def test_wrap_int32_is_the_value_modulo_2_32(shape):
    values = [0, -1, 2**31 - 1, 2**31, -(2**31) - 1, 2**32 + 5, -(2**40) - 7, 4293984256]
    n = int(np.prod(shape))
    for start in range(0, len(values), n):
        chunk = (values[start:] + values)[:n]
        total = torch.tensor(chunk, dtype=torch.int64).reshape(shape)
        got = bench_stages.wrap_int32(total)
        assert got.dtype == torch.int32 and got.shape == total.shape
        assert got.flatten().tolist() == [(v + 2**31) % 2**32 - 2**31 for v in chunk]


def _modulate_calls(monkeypatch, module) -> list[tuple]:
    """Record each modulate_device call of `module` (frames, offsets,
    total length, noise, seed) and make its capture without noise."""
    calls = []
    real = module.modulate_device

    def recorded(frames, offsets, total_len, amplitude=10000.0, noise_std=60.0, seed=0, **kw):
        calls.append((list(frames), list(offsets), total_len, noise_std, seed))
        return real(frames, offsets, total_len, amplitude, 0.0, seed, **kw)

    monkeypatch.setattr(module, "modulate_device", recorded)
    return calls


@pytest.mark.parametrize("block_len, seed", [(1 << 15, 0), (1 << 16, 3)])
def test_build_iq_equals_bench_fused(block_len, seed, monkeypatch):
    ours, theirs = _modulate_calls(monkeypatch, synth), _modulate_calls(monkeypatch, jax_synth)
    monkeypatch.setattr(jax_fused, "BLOCK", block_len)
    got = bench_stages.build_iq(seed, block_len, device="cpu")
    want = jax_fused.build_iq(seed)
    assert ours == theirs and len(ours) == 1 and ours[0][3] == 60.0
    assert len(ours[0][1]) == (block_len + bench_stages.HALO) // 16384
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))  # noise 0: the captures equal airjax's


def _jax_line_keys() -> set[str]:
    """The keys of tools/bench_stages.py's JSON line, read from its source."""
    for node in ast.walk(ast.parse((REPO / "tools" / "bench_stages.py").read_text())):
        if isinstance(node, ast.Dict) and any(isinstance(k, ast.Constant) and k.value == "stage" for k in node.keys):
            return {k.value for k in node.keys}
    raise AssertionError("tools/bench_stages.py has no line dict")


def _jax_stage_order() -> list[str]:
    """The stages of tools/bench_stages.py's main, in its order."""
    main = next(n for n in ast.parse((REPO / "tools" / "bench_stages.py").read_text()).body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    loop = next(n for n in ast.walk(main) if isinstance(n, ast.For))
    return [elt.elts[0].value for elt in loop.iter.elts]


def test_tool_prints_airjax_lines():
    """The tool as a script: the device line, then a line a stage in
    airjax's order with airjax's keys and the port's; r_big passes summed."""
    r_big, block_len = 3, 32768
    proc = subprocess.run([sys.executable, "airjax_torch/tools/bench_stages.py", "--torch-device", "cpu",
                           "--block-len", str(block_len), "--r-big", str(r_big)],
                          capture_output=True, text=True, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    head, *lines = proc.stdout.splitlines()
    assert head.startswith("device: cpu")
    rows = [json.loads(line) for line in lines]
    assert [r["stage"] for r in rows] == _jax_stage_order() == STAGE_ORDER == list(bench_stages.STAGES)
    iq = bench_stages.build_iq(0, block_len, device="cpu")
    for row in rows:
        assert set(row) == _jax_line_keys() | {"eager_seconds_per_pass", "device", "power_limit_w", "sums"}
        assert row["seconds_per_pass"] > 0
        assert row["msps"] == pytest.approx((block_len - WINDOW) / row["seconds_per_pass"] / 1e6)
        assert row["device"] == "cpu" and row["power_limit_w"] is None
        pair = bench_stages.STAGES[row["stage"]](iq, block_len - WINDOW, bench_stages.CAPACITY)
        assert row["sums"] == [r_big * int(x) for x in pair]


def test_tool_fails_without_a_card():
    proc = subprocess.run([sys.executable, "airjax_torch/tools/bench_stages.py", "--block-len", "32768"],
                          capture_output=True, text=True, timeout=300, cwd=REPO,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0 and "no CUDA card" in proc.stderr
    assert '"stage"' not in proc.stdout
