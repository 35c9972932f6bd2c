"""airjax_torch.parallel.multihost against airjax.parallel.multihost on the
CPU: airjax's single-process cases (tests/test_multihost.py, and the two of
tests/test_compact_gather.py) with airjax on its 8-device CPU mesh and the
port alone on 8 CPU shards; then real gloo jobs of 2 ranks x 4 shards and
4 x 2 over tcp://127.0.0.1 (tests/torch_multihost_worker.py, which refuses
jax), every rank's hits, packets, tracker state and stats held to airjax's
single-process decode of the whole capture (stats but `processes`). The
tolerance is 0: every output is an integer, a bit or a string."""

import dataclasses
import enum
import json
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from airjax.io import synth as jsynth
from airjax.parallel import multihost as jmultihost
from airjax.protocol import shortframe as jshortframe
from airjax.track.batch import ExtendedBatchTracker as JExtendedBatchTracker
from airjax.track.state import aircraft_to_json as jaircraft_to_json
from airjax_torch.extended import handle_extended_update
from airjax_torch.io import synth
from airjax_torch.parallel import halo, multihost
from airjax_torch.parallel.mesh import make_mesh
from airjax_torch.protocol import shortframe
from airjax_torch.track.batch import ExtendedBatchTracker
from torch_multihost_worker import captures, results
from torch_parity import airjax_builders_cached, assert_same_dict

REPO = pathlib.Path(__file__).resolve().parent.parent
WORKER = pathlib.Path(__file__).resolve().parent / "torch_multihost_worker.py"
ICAO = 0x7C6B30


@pytest.fixture(scope="module", autouse=True)
def _airjax_steps_once():
    """Each airjax step shape jit-compiles once in this module."""
    with airjax_builders_cached():
        yield


@pytest.fixture(scope="module")
def mesh():
    assert jmultihost.global_mesh().shape["t"] == 8, "conftest should provide 8 virtual devices"
    return make_mesh(8, device="cpu")


def packets(pkts) -> list:
    """[(offset, packet)] of either package as (offset, class, fields)."""

    def factory(items):
        return {k: (v.name if isinstance(v, enum.Enum) else v) for k, v in items}

    return [(o, type(p).__name__, dataclasses.asdict(p, dict_factory=factory)) for o, p in pkts]


def test_init_single_process():
    assert multihost.init() == jmultihost.init() == (0, 1)
    pm = multihost.global_mesh(local=make_mesh(3, device="cpu"))
    assert (pm.rank, pm.world, pm.size, pm.first_shard, pm.shape) == (0, 1, 3, 0, {"t": 3})


def test_init_nccl_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="NCCL needs a CUDA card"):
        multihost.init(init_method="tcp://127.0.0.1:1", world_size=1, rank=0)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        multihost.global_mesh()


def test_decode_capture_single_process(mesh):
    n = 4096 * 8
    frame = synth.make_df17(ICAO, synth.make_id_me("MHOST"))
    offsets = [700, 4096 - 100, n - 2000]  # includes a shard straddle
    iq = synth.modulate([frame] * len(offsets), offsets, n, seed=5)
    hits, stats = multihost.decode_capture(iq, mesh=mesh)
    assert (hits, stats) == jmultihost.decode_capture(iq)
    assert {h[1] for h in hits if h[2] == frame} >= set(offsets)
    assert stats["processes"] == 1 and stats["devices"] == 8


@pytest.mark.parametrize("axis", ["t", "c"])
def test_meshes_take_airjax_positional_axis(axis):
    """make_mesh(n, axis) and global_mesh(axis) take airjax's positional
    axis; the device and the local mesh come by keyword."""
    assert make_mesh(2, axis, device="cpu").axis == axis
    assert list(make_mesh(2, axis, device="cpu").devices) == [torch.device("cpu")] * 2
    pm = multihost.global_mesh(axis, local=make_mesh(1, axis, device="cpu"))
    assert pm.local.axis == axis and pm.shape == {axis: 1}


def test_decode_capture_binds_airjax_positional_arguments(mesh):
    """airjax's decode_capture(iq, 64): 64 is capacity_per_shard on both
    (the port's mesh by keyword), the same hits and stats."""
    n = 4096 * 8
    frames = [synth.make_df17(ICAO + i, synth.make_id_me(f"POS{i}")) for i in range(3)]
    iq = synth.modulate(frames, [900, 4096 * 3 - 50, n - 3000], n, seed=16)
    hits, stats = multihost.decode_capture(iq, 64, mesh=mesh)
    assert (hits, stats) == jmultihost.decode_capture(iq, 64)
    assert [h[2] for h in hits] == frames and stats["capacity_per_shard"] == 64


def test_decode_capture_extended_single_process(mesh):
    n = 4096 * 8
    frame = synth.make_df17(ICAO, synth.make_id_me("MHEXT"))
    df11 = shortframe.make_df11(0x40621D)
    df4 = shortframe.make_df4(0x40621D, 9000)
    offsets = [700, 4096 - 60, n - 2000]  # the DF11 straddles a shard edge; the DF4 is cache-gated
    iq = synth.modulate([frame, df11, df4], offsets, n, seed=6)
    got, stats = multihost.decode_capture_extended(iq, now=100.0, mesh=mesh)
    want, jstats = jmultihost.decode_capture_extended(iq, now=100.0)
    assert packets(got) == packets(want) and stats == jstats
    kinds = {off: type(p).__name__ for off, p in got}
    assert [kinds[o] for o in offsets] == ["AdsbPacket", "AllCallReply", "SurveillanceReply"]


@pytest.mark.parametrize("gather", ["compact", "dense"])
def test_decode_capture_regrows_on_overflow(mesh, gather):
    n = 4096 * 8
    frame = synth.make_df17(ICAO, synth.make_id_me("MHOVF"))
    offsets = [300, 1200, 2400, n - 2000]  # three in shard 0: capacity 1 overflows
    iq = synth.modulate([frame] * len(offsets), offsets, n, seed=7)
    hits, stats = multihost.decode_capture(iq, capacity_per_shard=1, gather=gather, mesh=mesh)
    assert (hits, stats) == jmultihost.decode_capture(iq, capacity_per_shard=1, gather=gather)
    assert {h[1] for h in hits if h[2] == frame} >= set(offsets)
    assert stats["capacity_per_shard"] > 1 and not stats["overflow"]


@pytest.mark.parametrize("gather", ["compact", "dense"])
def test_decode_capture_extended_regrows_on_overflow(mesh, gather):
    n = 4096 * 8
    df11 = shortframe.make_df11(0x40621D)
    offsets = [300, 1200, 2400, n - 2000]
    iq = synth.modulate([df11] * len(offsets), offsets, n, seed=8)
    got, stats = multihost.decode_capture_extended(iq, capacity_per_shard=1, now=100.0, gather=gather, mesh=mesh)
    want, jstats = jmultihost.decode_capture_extended(iq, capacity_per_shard=1, now=100.0, gather=gather)
    assert packets(got) == packets(want) and stats == jstats
    assert {off for off, p in got if type(p).__name__ == "AllCallReply"} >= set(offsets)
    assert stats["capacity_per_shard"] > 1 and not stats["overflow"]


def test_decode_capture_extended_batched_matches_per_packet(mesh):
    n = 4096 * 8
    frames = [
        synth.make_df17(ICAO, synth.make_id_me("MHBATCH")),
        shortframe.make_df11(0x40621D),
        shortframe.make_df4(0x40621D, 9000),
        synth.make_df17(ICAO, synth.make_position_me(tc=11, altitude_ft=5000, cpr_lat=93000, cpr_lon=51372,
                                                     odd=False)),
    ]
    iq = synth.modulate(frames, [700, 4096 - 60, 9000, n - 2000], n, seed=12)
    pkts, _ = multihost.decode_capture_extended(iq, now=100.0, mesh=mesh)
    per: dict = {}
    for _, pkt in pkts:
        handle_extended_update(pkt, per)
    tracker = ExtendedBatchTracker()
    applied, stats = multihost.decode_capture_extended_batched(iq, tracker, now=100.0, mesh=mesh)
    jtracker = JExtendedBatchTracker()
    assert (applied, stats) == jmultihost.decode_capture_extended_batched(iq, jtracker, now=100.0)
    assert applied == len(pkts) == 4 and stats["devices"] == 8
    assert per.keys() == tracker.aircrafts.keys() == jtracker.aircrafts.keys()
    a, b = per[ICAO], tracker.aircrafts[ICAO]
    assert a.callsign == b.callsign == jtracker.aircrafts[ICAO].callsign == "MHBATCH_"
    assert a.altitude == b.altitude == 5000
    assert per[0x40621D].altitude == tracker.aircrafts[0x40621D].altitude == 9000


def test_ingest_process_local(mesh):
    """This rank's shards: block then the next shard's head, the last
    shard's halo the capture's head (one process: the ring wraps)."""
    iq = np.random.default_rng(3).integers(-2000, 2000, (1024 * 8, 2)).astype(np.int16)
    shards = multihost.ingest_process_local(iq, mesh)
    assert len(shards) == 8 and all(tuple(s.shape) == (1024 + 239, 2) for s in shards)
    want = halo.shard_iq(iq, mesh, 1024, 239)
    assert all(torch.equal(a, b) for a, b in zip(shards, want))
    assert torch.equal(torch.cat([s[:1024] for s in shards]), torch.as_tensor(iq))
    with pytest.raises(ValueError, match="not divisible by 8 devices"):
        multihost.ingest_process_local(iq[:-4], mesh)


def test_attach_candidate_fields_equals_airjax(mesh):
    iq, iq_offsets = captures(jsynth, jshortframe)["extended"]
    gathered, _, _ = multihost._gather_extended_arrays(iq, mesh, 2048, "t")
    jgathered, _ = jmultihost._gather_extended_arrays(iq, 2048, "t")
    assert_same_dict(jgathered, gathered)
    multihost.attach_candidate_fields(gathered, device="cpu")
    jmultihost.attach_candidate_fields(jgathered)
    for key in ("fields", "short_fields"):
        assert_same_dict(jgathered[key], gathered[key])
    assert set(iq_offsets) <= set(gathered["offsets"].tolist())


def test_compact_matches_dense(mesh):
    """tests/test_compact_gather.py::test_multihost_single_process_compact_matches_dense."""
    block = 4096  # the shapes of the cases above: airjax compiles them once
    rng = np.random.default_rng(1)
    frame = synth.make_df17(ICAO, synth.make_id_me("PODCMP"))
    offsets = sorted(int(o) for o in rng.choice(np.arange(0, (8 * block - 240) // 300) * 300, 24, replace=False))
    iq = synth.modulate([frame] * len(offsets), offsets, 8 * block, seed=1)
    dh, ds = multihost.decode_capture(iq, capacity_per_shard=64, gather="dense", mesh=mesh)
    ch, cs = multihost.decode_capture(iq, capacity_per_shard=64, gather="compact", mesh=mesh)
    assert ch == dh and cs["n_good"] == ds["n_good"] == len(offsets)
    assert cs["fetched_bytes"] == len(offsets) * 22
    assert (ch, cs) == jmultihost.decode_capture(iq, capacity_per_shard=64, gather="compact")
    assert (dh, ds) == jmultihost.decode_capture(iq, capacity_per_shard=64, gather="dense")


def test_extended_batched_compact(mesh):
    """tests/test_compact_gather.py::test_multihost_extended_batched_compact."""
    block = 4096
    frame = synth.make_df17(ICAO, synth.make_id_me("PODCMP"))
    df11 = shortframe.make_df11(ICAO, capability=5)
    df4 = shortframe.make_df4(ICAO, altitude_ft=12000)
    iq = synth.modulate([df11, df4, frame], [200, block - 60, 2000], 8 * block, seed=2)
    td = ExtendedBatchTracker()
    ad, sd = multihost.decode_capture_extended_batched(iq, td, now=100.0, gather="dense", mesh=mesh)
    tc = ExtendedBatchTracker()
    ac, sc = multihost.decode_capture_extended_batched(iq, tc, now=100.0, gather="compact", mesh=mesh)
    assert ac == ad and sc["n_candidates"] >= 3
    assert tc.aircrafts[ICAO].altitude == td.aircrafts[ICAO].altitude == 12000
    assert tc.aircrafts[ICAO].get_callsign() == td.aircrafts[ICAO].get_callsign()
    for gather, applied, stats in (("dense", ad, sd), ("compact", ac, sc)):
        assert (applied, stats) == jmultihost.decode_capture_extended_batched(
            iq, JExtendedBatchTracker(), now=100.0, gather=gather)


@pytest.fixture(scope="module")
def airjax_whole():
    """airjax's single-process decodes of the workers' whole captures, on its 8 devices."""
    local = {name: iq for name, (iq, _) in captures(jsynth, jshortframe).items()}
    return results(jmultihost, JExtendedBatchTracker, jaircraft_to_json, local)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("world, shards", [(2, 4), (4, 2)])
def test_processes_equal_airjax(airjax_whole, world, shards):
    """A real gloo job: every rank's results equal airjax's decode of the
    whole capture; the frames that straddle the rank boundaries are found,
    and the regrow case regrew."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(WORKER), str(rank), str(world), str(port), str(shards)],
                              cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for rank in range(world)]
    outs = []
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=120)
            assert p.returncode == 0, f"worker failed:\n{stdout}\n{stderr}"
            outs.append(json.loads(next(ln for ln in stdout.splitlines() if ln.startswith("RESULT "))[7:]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert [o.pop("rank") for o in outs] == list(range(world))
    for out in outs:
        assert sorted(out) == sorted(airjax_whole)
        for name, want in airjax_whole.items():
            want, got = json.loads(json.dumps(want)), out[name]  # [result, stats(, tracker state)]
            assert got[1].pop("processes") == world and want[1].pop("processes") == 1, name
            assert got == want, name
    df17_offsets = captures(synth, shortframe)["df17"][1]
    assert {h[0] for h in outs[0]["df17_compact"][0]} >= set(df17_offsets)
    ext_offsets = captures(synth, shortframe)["extended"][1]
    assert {p[0] for p in outs[0]["extended_compact"][0]} >= set(ext_offsets)
    assert outs[0]["df17_regrow"][1]["capacity_per_shard"] > 1
    assert outs[0]["batched"][0] >= len(ext_offsets)
