"""parallel/halo.py::StepGraphs, the port's counterpart of airjax's jitted
shard_map step: a CUDA graph per step shape and slot on a card, the same
ring of slots and keys on the CPU, where a "replay" writes the plain step
into the slot's buffers. run_stream_sharded goes through it on a mesh of
one device; here its stream is held to airjax's run_stream_sharded on the
same IQ (packets, stats, the batched sinks' tables and the arrays a sink
keeps) on meshes of 1 and 8 shards, at pipeline depths 0-2, with regrows;
so is the eager step of a mesh over several cards (halo.EagerSteps). A
slot's shard views are held to shard_iq's buffers, the wrap included, and
the gather's layout (kernels/shard_gather.py::gather_layout) to the eager
gather's dict in every mode. The last test needs a card: a replay's dict
and launches against the eager step's. Every output is an integer or a
bit: the tolerance is exact equality."""

import math

import numpy as np
import pytest
import torch

from airjax.parallel.mesh import make_mesh as jmake_mesh
from airjax.runner import run_stream_sharded as jrun_stream_sharded
from airjax.track import batch as jbatch
from airjax_torch import pipeline
from airjax_torch.io import synth
from airjax_torch.kernels import block_decode, magdet, shard_gather
from airjax_torch.kernels.fields import layout_views
from airjax_torch.parallel import halo
from airjax_torch.parallel.mesh import Mesh, make_mesh
from airjax_torch.runner import run_stream_sharded
from airjax_torch.track import batch as tbatch
from test_torch_block_graphs import _Keep, _same_tree
from test_torch_runner_sharded import STATS, _key, _stream
from test_torch_track import state
from torch_parity import airjax_builders_cached, cuda_device  # noqa: F401

SHARD_BLOCK = 4880  # ≡ 784 mod 1024: the tuned class, a 240-sample halo
N_SAMPLES = 200_000


@pytest.fixture(scope="module", autouse=True)
def _airjax_steps_once():
    """Each airjax step shape jit-compiles once in this module."""
    with airjax_builders_cached():
        yield


@pytest.fixture(scope="module")
def meshes():
    return {d: (jmake_mesh(d), make_mesh(d, device="cpu")) for d in (1, 8)}


SINKS = {  # name -> (runner keywords, (airjax's sink, the port's) or None: per packet)
    "per_packet": ({}, None),
    "batched": ({}, (jbatch.BatchTracker, tbatch.BatchTracker)),
    "per_packet_recover2": ({"recover2": True}, None),
    "extended": ({"extended": True}, None),
    "extended_batched_recover2": ({"extended": True, "recover2": True},
                                  (jbatch.ExtendedBatchTracker, tbatch.ExtendedBatchTracker)),
}


def _run_both(meshes, d: int, kw: dict, sinks, depth: int, blocks=None):
    """The stream through airjax's and the port's run_stream_sharded on d
    shards -> the port's stats; its packets or table and its stats asserted
    equal to airjax's."""
    jmesh, tmesh = meshes[d]
    blocks = blocks or _stream(N_SAMPLES, seed=7 + d, extended=kw.get("extended", False),
                               flips=kw.get("recover2", False))
    kw = {"shard_block": SHARD_BLOCK, "pipeline_depth": depth, **kw}
    if sinks is None:
        got, want = [], []
        t_stats = run_stream_sharded(blocks(), got.append, mesh=tmesh, **kw)
        j_stats = jrun_stream_sharded(blocks(), want.append, mesh=jmesh, **kw)
        got, want = [_key(p) for p in got], [_key(p) for p in want]
    else:
        j_sink, t_sink = sinks[0](), sinks[1]()
        t_stats = run_stream_sharded(blocks(), t_sink, mesh=tmesh, **kw)
        j_stats = jrun_stream_sharded(blocks(), j_sink, mesh=jmesh, **kw)
        got, want = (state(t_sink.aircrafts), t_sink.n_messages), (state(j_sink.aircrafts), j_sink.n_messages)
    assert got == want
    t, j = t_stats.as_dict(), j_stats.as_dict()
    assert {k: t[k] for k in STATS} == {k: j[k] for k in STATS}
    return t_stats


def _steps_through_the_slots(stats, depth: int) -> None:
    """The warm-up is the key's first sighting; every step of the source a
    replay; each of the depth + 1 slots captured once."""
    g = stats.graphs
    steps = stats.fetches - 1  # the warm-up is fetched too
    assert (g["eager"], g["captures"], g["replays"]) == (1, min(steps, depth + 1), steps)
    assert g["pinned_bytes"] == g["device_bytes"] > (depth + 1) * SHARD_BLOCK * 4


@pytest.mark.parametrize("depth", [0, 1, 2])
@pytest.mark.parametrize("sink", list(SINKS))
def test_stream_through_the_step_slots_equals_airjax(meshes, sink, depth):
    """8 shards, 5-6 steps a stream (the last one padded)."""
    kw, sinks = SINKS[sink]
    stats = _run_both(meshes, 8, kw, sinks, depth)
    assert stats.good > 30
    if kw.get("recover2") and not sinks:
        assert stats.recovered2 > 0
    _steps_through_the_slots(stats, depth)


@pytest.mark.parametrize("sink", list(SINKS))
def test_one_shard_stream_through_the_step_slots_equals_airjax(meshes, sink):
    """make_mesh(1): a shard's wrap is its own head; ~43 steps at depth 1."""
    kw, sinks = SINKS[sink]
    stats = _run_both(meshes, 1, kw, sinks, 1)
    assert stats.good > 30 and stats.fetches > 40
    _steps_through_the_slots(stats, 1)


@pytest.mark.parametrize("sink", ["per_packet", "extended_batched_recover2"])
def test_eager_steps_equal_airjax(meshes, sink, monkeypatch):
    """halo.EagerSteps, the step of a mesh over several cards (staged,
    uploaded shard by shard, launched through the wrappers, fetched in two
    copies), in the graphs' place: the same stream, no graph."""
    monkeypatch.setattr(halo, "StepGraphs", halo.EagerSteps)
    kw, sinks = SINKS[sink]
    stats = _run_both(meshes, 8, kw, sinks, 2)
    assert stats.good > 30
    assert stats.graphs == {"eager": stats.fetches, "captures": 0, "replays": 0, "pinned_bytes": 0,
                            "device_bytes": 0}


@pytest.mark.parametrize("depth", [1, 2])
def test_regrow_reads_its_own_slot(meshes, depth):
    """K 2 and C 4 against ~8 frames a step: a step regrows from its own
    slot's device input while up to `depth` later steps fill the other
    slots, and the steps after run at the grown key (a first sighting of
    its own)."""
    stats = _run_both(meshes, 8, {"capacity_per_shard": 2, "compact_capacity": 4}, None, depth)
    g = stats.graphs
    assert stats.overflow_blocks >= 1 and g["eager"] >= 2
    assert stats.fetches > g["eager"] + g["replays"]  # a regrow fetches too


@pytest.mark.parametrize("extended", [False, True])
def test_kept_arrays_outlive_the_slots(meshes, extended):
    """One shard, depth 2, three slots written ~14 times each while the
    sink holds every array of every step; at the end each kept dict still
    equals airjax's for its step."""
    blocks = _stream(N_SAMPLES, seed=11, extended=extended)
    t_sink, j_sink = _Keep(), _Keep()
    kw = {"extended": extended, "shard_block": SHARD_BLOCK, "pipeline_depth": 2}
    stats = run_stream_sharded(blocks(), t_sink, mesh=meshes[1][1], **kw)
    jrun_stream_sharded(blocks(), j_sink, mesh=meshes[1][0], **kw)
    assert len(t_sink.kept) == len(j_sink.kept) > 40 and stats.graphs["replays"] == len(t_sink.kept)
    for want, got in zip(j_sink.kept, t_sink.kept):
        _same_tree(want, got)


@pytest.mark.parametrize("block", [SHARD_BLOCK, 3000])
@pytest.mark.parametrize("d", [1, 3, 8])
def test_slot_views_are_shard_iq(d, block):
    """Each slot's shard i is a view of the slot's device input, its rows
    i * block to (i + 1) * block + halo, and equals shard_iq's buffer bit
    for bit: the last shard's wrap onto the step's head (a one-shard
    mesh's onto its own) included; for every slot of the ring, eager,
    captured and replayed."""
    mesh = make_mesh(d, device="cpu")
    size = halo._halo_size(block)
    steps = halo.StepGraphs(mesh, block, 4, 16, depth=1)
    rng = np.random.default_rng(d)
    for _ in range(4):
        iq = rng.integers(-32768, 32768, (d * block, 2), dtype=np.int16)
        slot = steps.dispatch(iq)
        want = halo.shard_iq(iq, mesh, block, size)
        assert len(slot.shards) == d
        for i, (got, ref) in enumerate(zip(slot.shards, want)):
            assert got.data_ptr() == slot.device_iq.data_ptr() + 4 * i * block and got.shape == (block + size, 2)
            assert torch.equal(got, ref), i
        steps.fetch(slot)
        steps.done(slot)
    assert (steps.eager, steps.captures, steps.replays) == (1, 2, 3)


# The gather's modes: (extended, recover2, with_fields).
GATHERS = {
    "df17": (False, False, False),
    "df17_r2": (False, True, False),
    "df17_fields": (False, False, True),
    "extended": (True, False, False),
    "extended_r2_fields": (True, True, True),
}
D, K = 4, 32


def _step_iq(seed: int) -> np.ndarray:
    """A step of D shards: DF17 frames clean, with a 2-bit and a 1-bit flip,
    and other formats, two across shard edges, one across the wrap."""
    df17 = synth.make_df17(0xC10000 + seed, synth.make_id_me("STEP"))
    frames = [df17, synth.flip_bit(synth.flip_bit(df17, 30), 70), synth.flip_bit(df17, 40)]
    frames += synth.make_mixed_frames(2, seed)[:6]
    offsets = [300 + 1800 * i for i in range(len(frames))]
    offsets[1], offsets[4] = SHARD_BLOCK - 100, 3 * SHARD_BLOCK - 60
    return synth.modulate(frames, sorted(offsets), D * SHARD_BLOCK, seed=seed)


@pytest.mark.parametrize("c", [2, 64])
@pytest.mark.parametrize("mode", list(GATHERS))
def test_layout_equals_the_eager_gather(mode, c):
    """gather_layout covers both buffers once; the gather written into them
    (shard_gather_into) and read back through layout_views, as torch views
    and as numpy arrays, is shard_gather's dict, dtypes included, with C
    below the step's rows (an overflow) and above; and a StepGraphs fetch
    of the same step, eager, captured and replayed, is the eager step's."""
    extended, recover2, with_fields = GATHERS[mode]
    lay = shard_gather.gather_layout(c, extended, recover2, with_fields)
    cover = {"i": np.zeros(lay.n_int, int), "b": np.zeros(lay.n_byte, int)}
    for _, buf, start, shape, _ in lay.entries:
        cover[buf][start : start + math.prod(shape)] += 1
    assert all((n == 1).all() for n in cover.values())

    mesh = make_mesh(D, device="cpu")
    iq = _step_iq(5)
    outs = halo._decode_shards(mesh, iq, SHARD_BLOCK, 240, K, extended, recover2)
    args = (outs, SHARD_BLOCK, D * SHARD_BLOCK - 240, c)
    kw = {"extended": extended, "recover2": recover2, "with_fields": with_fields}
    want = pipeline.to_host(shard_gather.shard_gather(*args, **kw))
    assert int(want["n_candidates" if extended else "n_good"]) >= 3 and bool(want["overflow"]) == (c == 2)
    ints, byts = torch.zeros(lay.n_int, dtype=torch.int32), torch.zeros(lay.n_byte, dtype=torch.uint8)
    shard_gather.shard_gather_into(*args, ints, byts, **kw)
    for views in (pipeline.to_host(layout_views(lay.entries, ints, byts)),
                  layout_views(lay.entries, ints.numpy().copy(), byts.numpy().copy())):
        _same_tree(want, views)
        for key, v in views.items():
            if not isinstance(v, dict):
                assert v.dtype == want[key].dtype, key

    eager = halo._compact_builder(extended)(mesh, D * SHARD_BLOCK, K, c, recover2=recover2, with_fields=with_fields)
    steps = halo.StepGraphs(mesh, SHARD_BLOCK, K, c, depth=0, **kw)
    for seed in (5, 6, 5):  # eager, then the slot's capture and replay, then a replay
        step = _step_iq(seed)
        slot = steps.dispatch(step)
        _same_tree(pipeline.to_host(eager(step)), steps.fetch(slot))
        steps.done(slot)
    assert (steps.eager, steps.captures, steps.replays) == (1, 1, 2)


def test_slots_in_flight_beyond_the_ring_raise():
    """depth + 1 slots a key: a step more in flight than that would
    overwrite one, and raises instead; a fetched, done slot is taken again."""
    steps = halo.StepGraphs(make_mesh(2, device="cpu"), 3000, 4, 16, depth=1)
    iq = pipeline.pad_iq_non_detecting(np.zeros((0, 2), np.int16), 6000)
    a, b = steps.dispatch(iq), steps.dispatch(iq)
    assert a is not b
    with pytest.raises(RuntimeError, match="StepGraphs slot is still in flight"):
        steps.dispatch(iq)
    steps.fetch(a), steps.done(a)
    assert steps.dispatch(iq) is a
    with pytest.raises(ValueError, match=r"expected \(6000, 2\)"):
        steps.dispatch(iq[:5000])


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 4])
@pytest.mark.parametrize("mode", list(GATHERS))
def test_replay_equals_the_eager_step_on_the_card(mode, d, cuda_device):  # noqa: F811
    """On the card, on Mesh([card] * d): a replay's dict is the eager
    step's bit for bit, on a step other than the one the slot was captured
    after, and each replay adds d fronts, d block decodes and one gather
    (F where batched) to the wrappers' counts."""
    extended, recover2, with_fields = GATHERS[mode]
    mesh = Mesh([cuda_device] * d)
    n = d * SHARD_BLOCK
    eager = halo._compact_builder(extended)(mesh, n, K, 64, recover2=recover2, with_fields=with_fields)
    steps = halo.StepGraphs(mesh, SHARD_BLOCK, K, 64, depth=0, extended=extended, recover2=recover2,
                            with_fields=with_fields)
    iqs = [_step_iq(20 + i)[:n] for i in range(3)]

    def counts():
        return (magdet.bits_launches, block_decode.launches, block_decode.fields_launches, shard_gather.launches,
                shard_gather.fields_launches)

    for i, iq in enumerate(iqs + iqs[:1]):
        want = pipeline.to_host(eager(torch.as_tensor(iq, device=cuda_device)))
        before = counts()
        slot = steps.dispatch(iq)
        got = steps.fetch(slot)
        steps.done(slot)
        _same_tree(want, got)
        assert tuple(a - b for a, b in zip(counts(), before)) == (d, d, 0, 1, int(with_fields)), i
    assert (steps.eager, steps.captures, steps.replays) == (1, 1, 3)
