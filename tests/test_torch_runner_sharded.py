"""airjax_torch.runner.run_stream_sharded and `adsb --devices` against
airjax on the CPU: the cases of tests/test_runner_sharded.py, airjax on its
8-device CPU mesh, the port on 8 CPU shards. The emitted packet stream
equals airjax's run_stream_sharded and the port's own run_stream in overlap
mode; so does every stat but `detections`, which the sharded runners count
twice at step edges by design (they must equal each other's)."""

import contextlib
import dataclasses
import enum
import io
import re

import numpy as np
import pytest
import torch

from airjax.config import DEFAULT_CONFIG
from airjax.io import synth
from airjax.parallel.halo import HALO, tuned_block
from airjax.parallel.mesh import make_mesh as jmake_mesh
from airjax.protocol import shortframe
from airjax.runner import run_stream_sharded as jrun_stream_sharded
from airjax.track.batch import BatchTracker as JBatchTracker
from airjax.track.batch import ExtendedBatchTracker as JExtendedBatchTracker
from airjax_torch import cli
from airjax_torch.io.source import Prefetcher
from airjax_torch.parallel.mesh import make_mesh
from airjax_torch.runner import StreamStats, run_stream, run_stream_sharded
from airjax_torch.track.batch import BatchTracker, ExtendedBatchTracker
from torch_parity import airjax_builders_cached

ICAO = 0x7C6B30
# Fresh samples a sharded step at the runner's default shard block.
STEP_F = tuned_block(max(16384, DEFAULT_CONFIG.block_len)) * 8 - HALO
STATS = ("blocks", "samples", "detections", "good", "recovered", "recovered2", "overflow_blocks")


@pytest.fixture(scope="module", autouse=True)
def _airjax_steps_once():
    """Each airjax step shape jit-compiles once in this module."""
    with airjax_builders_cached():
        yield


@pytest.fixture(scope="module")
def meshes():
    return jmake_mesh(8), make_mesh(8, device="cpu")


def _stream(n_total, extra_offsets=(), seed=5, extended=False, flips=False):
    """40 frames on a 400-sample grid (plus extra_offsets) in 20,000-sample
    blocks; extended: DF17, DF11 and DF4 in turn; flips: every fifth DF17
    sent with a 2-bit flip (a recover2 repair)."""
    frame = synth.make_df17(ICAO, synth.make_id_me("SHRDSTRM"))
    rng = np.random.default_rng(seed)
    offsets = sorted(set(rng.choice(np.arange(1, (n_total - 400) // 400) * 400, 40, replace=False).tolist())
                     | set(extra_offsets))
    frames = [frame] * len(offsets)
    if extended:
        frames = [[frame, shortframe.make_df11(ICAO, capability=5), shortframe.make_df4(ICAO, altitude_ft=12000)][i % 3]
                  for i in range(len(offsets))]
    if flips:
        frames = [synth.flip_bit(synth.flip_bit(f, 30), 70) if i % 5 == 4 and f[0] >> 3 == 17 else f
                  for i, f in enumerate(frames)]
    iq = np.asarray(synth.modulate(frames, list(map(int, offsets)), n_total, noise_std=25.0, seed=seed))
    return lambda: (iq[i : i + 20000] for i in range(0, n_total, 20000))


def _key(p) -> tuple:
    """A packet of either package without its wall-clock receipt time."""

    def factory(items):
        return {k: (v.name if isinstance(v, enum.Enum) else v) for k, v in items if k != "time_processed"}

    return type(p).__name__, dataclasses.asdict(p, dict_factory=factory)


def _three(meshes, blocks, t_stats=None, **kw):
    """The stream through airjax's and the port's sharded runners and the
    port's run_stream -> the three (packets, stats), asserted equal. The
    port's sharded runner counts into `t_stats` where one is given."""
    runs = []
    for run in (lambda s: jrun_stream_sharded(blocks(), s, mesh=meshes[0], **kw),
                lambda s: run_stream_sharded(blocks(), s, mesh=meshes[1], stats=t_stats, **kw),
                lambda s: run_stream(blocks(), s, device="cpu", extended=kw.get("extended", False),
                                     recover2=kw.get("recover2", False))):
        got = []
        stats = run(got.append).as_dict()
        runs.append(([_key(p) for p in got], stats))
    (want, s_j), (got, s_t), (single, s_1) = runs
    assert got == want == single
    assert {k: s_t[k] for k in STATS} == {k: s_j[k] for k in STATS}
    assert s_t["good"] == s_1["good"] and s_t["recovered"] == s_1["recovered"]
    assert s_t["recovered2"] == s_1["recovered2"] and s_t["detections"] >= s_1["detections"]
    return got, s_t


def test_parity_hit_stream_equality(meshes):
    # Straddling a source-block edge, the first step's edge and shard edges.
    blocks = _stream(400_000, extra_offsets=[19_899, 39_947, STEP_F - 120, 2 * STEP_F - 60])
    got, stats = _three(meshes, blocks)
    assert stats["good"] == len(got) > 40


def test_parity_tail_partial_step(meshes):
    # Shorter than one step: all of it through the padded last step.
    got, _ = _three(meshes, _stream(60_000, extra_offsets=[59_700]))
    assert got


def test_parity_overflow_regrow(meshes):
    _, stats = _three(meshes, _stream(300_000), capacity_per_shard=2, compact_capacity=4)
    assert stats["overflow_blocks"] >= 1


@pytest.mark.parametrize("depth", [1, 3])
def test_overflow_regrow_fetched_early(meshes, depth, monkeypatch):
    """The source never has a block ready: every step is fetched before
    the next is dispatched, yet each runs at the K and C airjax's would,
    so the regrows, and the stats, are airjax's."""
    monkeypatch.setattr(Prefetcher, "ready", lambda self: False)
    stats = StreamStats()
    _, s = _three(meshes, _stream(300_000), t_stats=stats, capacity_per_shard=2, compact_capacity=4,
                  pipeline_depth=depth)
    assert s["overflow_blocks"] >= 2 and stats.early_fetches == stats.fetches - 1


@pytest.mark.parametrize("extended", [False, True])
def test_recover2_streams(meshes, extended):
    _, stats = _three(meshes, _stream(300_000, extended=extended, flips=True), extended=extended, recover2=True)
    assert stats["recovered2"] > 0


def test_parity_batched_tracker_state(meshes):
    blocks = _stream(300_000)
    t_j, t_t, t_1 = JBatchTracker(), BatchTracker(), BatchTracker()
    jrun_stream_sharded(blocks(), t_j, mesh=meshes[0])
    run_stream_sharded(blocks(), t_t, mesh=meshes[1])
    run_stream(blocks(), t_1, device="cpu")
    assert set(t_j.aircrafts) == set(t_t.aircrafts) == set(t_1.aircrafts) == {ICAO}
    assert t_t.aircrafts[ICAO].get_callsign() == t_j.aircrafts[ICAO].get_callsign() == "SHRDSTRM"
    assert t_t.n_messages == t_j.n_messages == t_1.n_messages


def test_extended_packet_stream_equality(meshes):
    _, stats = _three(meshes, _stream(300_000, extra_offsets=[STEP_F - 150], extended=True), extended=True)
    assert stats["good"] > 30


def test_extended_batched_tracker_state(meshes):
    blocks = _stream(300_000, extended=True)
    t_j, t_t, t_1 = JExtendedBatchTracker(), ExtendedBatchTracker(), ExtendedBatchTracker()
    jrun_stream_sharded(blocks(), t_j, mesh=meshes[0], extended=True)
    run_stream_sharded(blocks(), t_t, mesh=meshes[1], extended=True)
    run_stream(blocks(), t_1, device="cpu", extended=True)
    assert set(t_j.aircrafts) == set(t_t.aircrafts) == set(t_1.aircrafts) == {ICAO}
    a_j, a_t, a_1 = (t.aircrafts[ICAO] for t in (t_j, t_t, t_1))
    assert a_t.get_callsign() == a_j.get_callsign() == a_1.get_callsign()
    assert (a_t.altitude, a_t.squawk) == (a_j.altitude, a_j.squawk) == (a_1.altitude, a_1.squawk)
    assert t_t.n_messages == t_j.n_messages


def _cli(argv) -> tuple[int, str]:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    return rc, out.getvalue()


def test_cli_devices_flag():
    from airjax import cli as jcli

    rc, text = _cli(["adsb", "--synthetic", "12", "--devices", "2", "--torch-device", "cpu"])
    assert rc == 0 and "stats:" in text and "'good': 0" not in text
    # The same packets as airjax's `adsb --synthetic 12 --devices 2`, and as the port without --devices.
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert jcli.main(["adsb", "--synthetic", "12", "--devices", "2"]) == 0

    def dumps(s):
        return re.findall(r"^== ([0-9a-f]+) ==$", s, re.M)

    assert dumps(text) == dumps(out.getvalue()) == dumps(_cli(["adsb", "--synthetic", "12", "--torch-device", "cpu"])[1])
    assert len(dumps(text)) > 0


def test_cli_devices_rejects_no_overlap(capsys):
    assert cli.main(["adsb", "--synthetic", "1", "--devices", "2", "--no-overlap", "--torch-device", "cpu"]) == 2
    assert "--devices requires overlap mode" in capsys.readouterr().err
    # airjax's single-device debug aids are refused with --devices, as airjax refuses them.
    assert cli.main(["adsb", "--synthetic", "1", "--devices", "2", "--dump-preamble", "--torch-device", "cpu"]) == 2
    assert "single-device debug aids" in capsys.readouterr().err


@pytest.mark.parametrize("idle", [False, True], ids=["ready", "idle"])
def test_pipeline_depth_invariance(meshes, idle, monkeypatch):
    """How many steps are in flight does not change the stream. `idle`: the
    port's source never has a block ready (Prefetcher.ready forced false),
    so at depths 1 and 3 every step is fetched early, as run_stream's
    blocks are, but the warm-up step, fetched before the source is read."""
    if idle:
        monkeypatch.setattr(Prefetcher, "ready", lambda self: False)
    blocks = _stream(400_000, extra_offsets=[STEP_F - 130])
    outs = []
    for depth in (0, 1, 3):
        stats = StreamStats()
        got, _ = _three(meshes, blocks, t_stats=stats, pipeline_depth=depth)
        outs.append(got)
        if idle and depth:
            assert stats.early_fetches == stats.fetches - 1, depth
    assert outs[0] == outs[1] == outs[2] and len(outs[0]) > 40


def test_needs_a_mesh_or_a_device():
    """With neither, the stream takes every card, as airjax's takes every
    device: where there is none it raises, never falling back to the CPU."""
    if torch.cuda.is_available():
        assert run_stream_sharded(iter(()), print).good == 0
    else:
        with pytest.raises(ValueError, match="requested 0 devices, have 0"):
            run_stream_sharded(iter(()), print)
    assert run_stream_sharded(iter(()), print, n_devices=3, device="cpu").good == 0
