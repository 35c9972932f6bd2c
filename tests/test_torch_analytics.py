"""airjax_torch.analytics against airjax.analytics on the CPU: the cases of
tests/test_analytics.py, each with the port's tracks (every dataclass
field, floats exactly) and stats equal to airjax's, devices=8 included
(airjax on its 8-device CPU mesh, the port on 8 CPU shards); and the port's
replay tool once on a capture."""

import dataclasses
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from airjax import analytics as janalytics
from airjax.io import synth
from airjax.protocol import shortframe
from airjax_torch import analytics
from airjax_torch.io.c16 import save_c16
from airjax_torch.protocol.packet import AdsbPacket
from airjax_torch.track.aircraft import handle_aircraft_update
from torch_parity import airjax_builders_cached

REPO = pathlib.Path(__file__).resolve().parent.parent
ICAO_A = 0x7C6B30
ICAO_B = 0x4840D6
POS = (-41.3, 174.8)
ALT = 10000


@pytest.fixture(scope="module", autouse=True)
def _airjax_steps_once():
    """Each airjax step shape jit-compiles once in this module."""
    with airjax_builders_cached():
        yield


def _position(odd: bool) -> bytes:
    return synth.make_df17(ICAO_A, synth.make_position_me(11, ALT, *synth.encode_airborne_cpr(*POS, odd=odd), odd=odd))


def _capture():
    frames = [synth.make_df17(ICAO_A, synth.make_id_me("ANLYT1")), _position(False), _position(True),
              synth.make_df17(ICAO_B, synth.make_id_me("ANLYT2"))]
    return synth.modulate(frames, [500, 9000, 21000, 33000], 60000, noise_std=20.0, seed=5)


def _extended_capture():
    frames = [synth.make_df17(ICAO_A, synth.make_id_me("EXTANL")), _position(False), _position(True),
              synth.make_df17(ICAO_A, synth.make_velocity_me(ew_kt=100, ns_kt=75, vertical_rate_fpm=-640)),
              shortframe.make_df11(ICAO_B), shortframe.make_df5(ICAO_B, 7421), shortframe.make_df4(ICAO_B, 12000)]
    return synth.modulate(frames, [500, 9000, 21000, 33000, 40000, 44000, 48000], 60000, noise_std=20.0, seed=7)


def _both(iq, extended=False, **kw):
    """The capture through airjax's and the port's analysis; asserts the
    tracks and stats equal and returns the port's."""
    if extended:
        want = janalytics.analyze_capture_extended(iq, **kw)
        got = analytics.analyze_capture_extended(iq, device="cpu", **kw)
    else:
        want = janalytics.analyze_capture(iq, **kw)
        got = analytics.analyze_capture(iq, device="cpu", **kw)
    assert {k: dataclasses.asdict(t) for k, t in got[0].items()} == {
        k: dataclasses.asdict(t) for k, t in want[0].items()}
    assert [type(t).__name__ for t in got[0].values()] == [type(t).__name__ for t in want[0].values()]
    assert got[1] == want[1]
    return got


def test_tracks_and_fixes():
    tracks, stats = _both(_capture())
    assert stats["n_aircraft"] == 2
    a = tracks[ICAO_A]
    assert a.callsign == "ANLYT1__" and a.n_messages >= 3
    assert a.altitudes and all(alt == ALT for _, alt in a.altitudes)
    assert stats["n_fixes"] >= 1 and a.fixes
    fix = a.fixes[0]
    assert abs(fix.latitude - POS[0]) < 1e-3 and abs(fix.longitude - POS[1]) < 1e-3 and fix.altitude_ft == ALT
    b = tracks[ICAO_B]
    assert b.callsign == "ANLYT2__" and not b.fixes


def test_fix_matches_online_tracker():
    """The analysis' pairing reproduces the port's online tracker."""
    aircrafts = {}
    handle_aircraft_update(AdsbPacket.from_bytes(_position(False), 100.0), aircrafts)
    handle_aircraft_update(AdsbPacket.from_bytes(_position(True), 101.0), aircrafts)
    online = aircrafts[ICAO_A].geo_position
    assert online is not None
    fix = _both(_capture())[0][ICAO_A].fixes[0]
    assert (fix.latitude, fix.longitude) == (online.latitude, online.longitude)


def test_empty_capture():
    iq = np.random.default_rng(0).integers(-50, 50, size=(30000, 2), dtype=np.int16)
    tracks, stats = _both(iq)
    assert stats["n_fixes"] == 0 and not any(t.fixes for t in tracks.values())


def test_extended_analytics_tracks():
    tracks, stats = _both(_extended_capture(), extended=True)
    assert stats["n_aircraft"] == 2
    a = tracks[ICAO_A]
    assert a.callsign == "EXTANL__" and a.kinds == {"AdsbPacket": 4}
    assert len(a.fixes) == 1 and abs(a.fixes[0].latitude - POS[0]) < 0.01 and a.fixes[0].offset == 21000
    (off, gs, _, vr), = a.velocities
    assert off == 33000 and vr == -640 and abs(gs - (100**2 + 75**2) ** 0.5) < 1e-6
    b = tracks[ICAO_B]
    assert b.kinds == {"AllCallReply": 1, "SurveillanceReply": 2}
    assert b.squawks == [(44000, 7421)] and b.altitudes[-1] == (48000, 12000)


def test_extended_analytics_empty():
    iq = np.clip(np.round(np.random.default_rng(0).normal(0, 30, (40000, 2))), -128, 127).astype(np.int16)
    tracks, stats = _both(iq, extended=True)
    assert tracks == {} and stats["n_aircraft"] == 0


@pytest.mark.parametrize("extended", [False, True])
def test_devices_param_identical_tracks(extended):
    """devices=8 (the halo-sharded mesh) gives airjax's devices=8 tracks and
    the single-device decode's."""
    iq = _extended_capture() if extended else _capture()
    one = _both(iq, extended)
    eight = _both(iq, extended, devices=8)
    assert [dataclasses.asdict(t) for t in eight[0].values()] == [dataclasses.asdict(t) for t in one[0].values()]
    assert eight[1]["n_fixes"] == one[1]["n_fixes"]


def test_extended_capacity_regrows():
    # K = 4 for 7 frames and ~40 preamble detections: K and C regrow.
    tracks, stats = _both(_extended_capture(), extended=True, capacity_per_shard=4)
    assert stats["capacity_per_shard"] > 4 and stats["compact_capacity"] > 512 and len(tracks) == 2


def test_devices_raises_past_the_cards():
    import torch

    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    for analyze in (analytics.analyze_capture, analytics.analyze_capture_extended):
        with pytest.raises(ValueError, match="requested"):
            analyze(_capture(), devices=have + 1, device="cuda")


@pytest.mark.parametrize("extended", [False, True])
def test_replay_tool(tmp_path, extended):
    """airjax_torch/tools/replay_analytics.py on the CPU: one JSON line per
    aircraft, the stats, and the report file, as airjax's tool prints them."""
    path = tmp_path / "cap.c16"
    save_c16(_extended_capture() if extended else _capture(), str(path))
    argv = [str(path), "--json", str(tmp_path / "r.json"), "--devices", "2"] + (["--extended"] if extended else [])
    proc = subprocess.run([sys.executable, str(REPO / "airjax_torch/tools/replay_analytics.py"), *argv,
                           "--torch-device", "cpu"], capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr
    lines = [json.loads(ln) for ln in proc.stdout.splitlines()]
    assert [ln["icao"] for ln in lines] == [f"{ICAO_B:06x}", f"{ICAO_A:06x}"]  # sorted by ICAO
    report = json.loads((tmp_path / "r.json").read_text())
    assert report["aircraft"] == lines and f"stats: {json.dumps(report['stats'])}" in proc.stderr
    want = janalytics.analyze_capture_extended(_extended_capture(), devices=2) if extended else (
        janalytics.analyze_capture(_capture(), devices=2))
    assert report["stats"] == want[1]
    a = next(ln for ln in lines if ln["icao"] == f"{ICAO_A:06x}")
    assert a["fixes"] and a["fixes"][0]["lat"] == round(want[0][ICAO_A].fixes[0].latitude, 6)
    if extended:
        assert a["kinds"] == {"AdsbPacket": 4} and a["velocities"][0]["vr_fpm"] == -640
