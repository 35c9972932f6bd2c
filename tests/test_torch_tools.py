"""The port's tiers of the root tools on the CPU (airjax_torch/tools/): the
two parity fuzzers, the soak in its modes (the live one through the fake
SoapySDR) and the multi-device dry run, each for a few iterations or
seconds, exit 0; each fuzzer exits 1 when a tier's decode is made wrong.
The SNR sweep's curves equal airjax's tools/snr_sweep.py's, point for
point, in its three modes with the golden check; it exits 1 when the
decode loses a frame the golden decoder finds."""

import importlib.util
import json
import pathlib
import subprocess
import sys

import pytest

from airjax_torch import native, pipeline
from airjax_torch.io import synth
from airjax_torch.io.c16 import save_c16
from airjax_torch.tools import dryrun_multichip, fuzz_extended, fuzz_parity, snr_sweep, soak

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


def _airjax_snr_sweep():
    """airjax's tools/snr_sweep.py, loaded from its path (tools/ is no
    package)."""
    spec = importlib.util.spec_from_file_location("airjax_snr_sweep", REPO / "tools" / "snr_sweep.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


SWEEP_SIZE = {"snrs_db": (4.0, 8.0, 14.0), "captures_per_snr": 2, "check_golden": True}


@pytest.mark.parametrize("mode", ["df17", "recover2", "extended"])
def test_snr_sweep_equals_airjax(mode):
    theirs = _airjax_snr_sweep()
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


def test_tools_run_as_scripts():
    """Each tool runs from a checkout by its path, as the README gives it."""
    for argv in (["fuzz_parity.py", "--iters", "2"], ["dryrun_multichip.py", "2"],
                 ["snr_sweep.py", "--captures", "1", "--extended"]):
        proc = subprocess.run([sys.executable, f"airjax_torch/tools/{argv[0]}", *argv[1:], *CPU],
                              capture_output=True, text=True, timeout=300, cwd=REPO)
        assert proc.returncode == 0, proc.stderr
