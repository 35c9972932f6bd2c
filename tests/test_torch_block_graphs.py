"""pipeline.BlockGraphs, the port's counterpart of airjax's jit of the
decode_iq_block* family: a CUDA graph per block shape and slot on a card,
the same ring of slots and keys on the CPU, where a "replay" writes the
plain decode into the slot's buffers. run_stream and decode_capture_overlap
go through it; here they are held to airjax's on the same IQ (packets,
stats, the batched sinks' tables and the arrays a sink keeps), at every
pipeline depth, with regrows, changing block shapes and the tail flush.
The layout the device wrapper and the host fetch share
(kernels/block_decode.py::dict_layout) is held to the eager dict of every
decode variant. The last tests need a card: a replay's dict and launches
against the eager wrappers'. Every output is an integer or a bit: the
tolerance is exact equality."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from airjax import pipeline as jpipeline
from airjax import runner as jrunner
from airjax.config import PipelineConfig as JConfig
from airjax.track import batch as jbatch
from airjax_torch import pipeline, runner
from airjax_torch.config import PipelineConfig
from airjax_torch.io import synth
from airjax_torch.kernels import block_decode, magdet
from airjax_torch.kernels.fields import layout_views
from airjax_torch.kernels.magdet import magdet_bits
from airjax_torch.track import batch as tbatch
from test_torch_track import state
from torch_parity import assert_same, cuda_device, packet_fields  # noqa: F401

CHUNK = 20000
DEPTHS = (0, 1, 2, 4)


def _capture(n: int, seed: int, extended: bool = False, spacing: int = 2900) -> np.ndarray:
    """n samples of traffic: frames on a grid with jitter, one across each
    20,000-sample edge; every format with extended."""
    rng = np.random.default_rng(seed)
    pool = synth.make_mixed_frames(3, seed) if extended else [
        synth.make_df17(0xB00000 + i, synth.make_id_me(f"GRPH{i:03d}")) for i in range(5)]
    grid = np.arange(300, n - 400, spacing)
    offsets = sorted(set((grid + rng.integers(0, 200, len(grid))).tolist())
                     | {e - 120 for e in range(CHUNK, n - 400, CHUNK)})
    offsets = [o for i, o in enumerate(offsets) if i == 0 or o - offsets[i - 1] >= 250]
    frames = [pool[i % len(pool)] for i in range(len(offsets))]
    return synth.modulate(frames, offsets, n, noise_std=30.0, seed=seed)


def _blocks(iq: np.ndarray, sizes):
    """iq in blocks of the given sizes, the last size repeated, the last block ragged."""
    def gen():
        i, k = 0, 0
        while i < len(iq):
            size = sizes[min(k, len(sizes) - 1)]
            yield iq[i : i + size]
            i += size
            k += 1

    return gen


def _view(p) -> tuple:
    name, fields = packet_fields(p)
    return name, {k: v for k, v in fields.items() if k != "time_processed"}


def _stats(stats) -> dict:
    return {k: v for k, v in stats.as_dict().items() if k not in ("stages", "msamples_per_s")}


SINKS = {
    "per_packet": ({}, None),
    "batched": ({}, (jbatch.BatchTracker, tbatch.BatchTracker)),
    "extended_batched_recover2": ({"extended": True, "recover2": True},
                                  (jbatch.ExtendedBatchTracker, tbatch.ExtendedBatchTracker)),
}


def _run_both(blocks, kw: dict, sinks, depth: int, cfg=None):
    """The stream through both packages -> the port's stats; its packets or
    table and its stats asserted equal to airjax's."""
    t_cfg = {} if cfg is None else {"cfg": PipelineConfig(**cfg)}
    j_cfg = {} if cfg is None else {"cfg": JConfig(**cfg)}
    if sinks is None:
        got, want = [], []
        t_stats = runner.run_stream(blocks(), got.append, device="cpu", pipeline_depth=depth, **kw, **t_cfg)
        j_stats = jrunner.run_stream(blocks(), want.append, pipeline_depth=depth, **kw, **j_cfg)
        got, want = [_view(p) for p in got], [_view(p) for p in want]
    else:
        j_sink, t_sink = sinks[0](), sinks[1]()
        t_stats = runner.run_stream(blocks(), t_sink, device="cpu", pipeline_depth=depth, **kw, **t_cfg)
        j_stats = jrunner.run_stream(blocks(), j_sink, pipeline_depth=depth, **kw, **j_cfg)
        got, want = (state(t_sink.aircrafts), t_sink.n_messages), (state(j_sink.aircrafts), j_sink.n_messages)
    assert got == want
    assert _stats(t_stats) == _stats(j_stats)
    return t_stats


@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("sink", list(SINKS))
def test_stream_through_the_slots_equals_airjax(sink, depth):
    """20,000-sample blocks, one shape: the first block runs eagerly, each
    of the depth + 1 slots is captured at its first use after it, and every
    later block is a replay."""
    kw, sinks = SINKS[sink]
    n_blocks = 7
    iq = _capture(n_blocks * CHUNK, 30 + depth, extended=kw.get("extended", False))
    stats = _run_both(_blocks(iq, [CHUNK]), kw, sinks, depth)
    assert stats.blocks == n_blocks and stats.good > 20
    g = stats.graphs
    assert (g["eager"], g["captures"], g["replays"]) == (1, min(n_blocks - 1, depth + 1), n_blocks - 1)
    assert stats.fetches == n_blocks and stats.overlapped == 0
    assert g["pinned_bytes"] == g["device_bytes"] > (depth + 1) * (CHUNK + 239) * 4


@pytest.mark.parametrize("depth", [2, 4])
def test_regrow_reads_its_own_slot(depth):
    """A capacity of 4 against 7 or more frames a block: each block regrows
    from its own slot's device input while up to `depth` later blocks fill
    the other slots."""
    iq = _capture(9 * CHUNK, 40, spacing=2600)
    stats = _run_both(_blocks(iq, [CHUNK]), {}, None, depth, cfg={"max_candidates": 4})
    assert stats.overflow_blocks == stats.blocks == 9
    assert stats.fetches >= 2 * stats.blocks  # a regrow or more a block
    assert stats.graphs["eager"] + stats.graphs["replays"] == stats.blocks


# Short reads (7000, 100), a tuned block of 2^16+ samples between
# 20,000-sample ones (its carry changes the next block's shape), and a
# tuned block last (its carry is the tail flush).
SHAPE_SIZES = [CHUNK, CHUNK, 7000, CHUNK, 70000, CHUNK, CHUNK, 100, CHUNK, CHUNK, 70003, 70003]


@pytest.mark.parametrize("depth", [0, 2])
@pytest.mark.parametrize("sink", ["per_packet", "batched"])
def test_changing_block_shapes_equal_airjax(sink, depth):
    kw, sinks = SINKS[sink]
    iq = _capture(sum(SHAPE_SIZES), 50)
    stats = _run_both(_blocks(iq, SHAPE_SIZES), kw, sinks, depth)
    g = stats.graphs
    decodes = stats.fetches  # no regrow at the default capacity
    assert stats.overflow_blocks == 0 and g["eager"] + g["replays"] == decodes == stats.blocks + 1  # + the tail
    assert g["eager"] >= 5 and g["replays"] >= 5


class _Keep:
    """A batched sink that keeps every array it is handed, by reference,
    and applies nothing."""

    def __init__(self):
        self.kept = []

    def on_fields(self, fields, idx, now):
        self.kept.append({"fields": fields, "idx": idx})
        return 0

    def on_extended_block(self, out, now, cache, min_offset=None):
        self.kept.append(out)
        return 0


def _same_tree(want, got, path="") -> None:
    assert sorted(want) == sorted(got), path
    for key in want:
        if isinstance(want[key], dict):
            _same_tree(want[key], got[key], f"{path}/{key}")
        else:
            assert_same(want[key], got[key], f"{path}/{key}")


@pytest.mark.parametrize("extended", [False, True])
def test_kept_arrays_outlive_the_slots(extended):
    """Depth 2, three slots, 9 blocks: every slot is written three times
    while the sink holds every array of every block; at the end each kept
    dict still equals airjax's for its block."""
    iq = _capture(9 * CHUNK, 60, extended=extended)
    t_sink, j_sink = _Keep(), _Keep()
    kw = {"extended": extended}
    t_stats = runner.run_stream(_blocks(iq, [CHUNK])(), t_sink, device="cpu", pipeline_depth=2, **kw)
    jrunner.run_stream(_blocks(iq, [CHUNK])(), j_sink, pipeline_depth=2, **kw)
    assert len(t_sink.kept) == len(j_sink.kept) == 9 and t_stats.graphs["replays"] == 8
    for want, got in zip(j_sink.kept, t_sink.kept):
        _same_tree(want, got)


@pytest.mark.parametrize("capacity", [256, 4])
def test_overlap_scan_through_the_slots_equals_airjax(capacity):
    """decode_capture_overlap's blocks are slices of the resident capture,
    copied into one slot and replayed; capacity 4 regrows every block."""
    iq = _capture(5 * CHUNK + 3000, 70)
    cfg = {"block_len": CHUNK, "max_candidates": capacity}
    got = pipeline.decode_capture_overlap(iq, PipelineConfig(**cfg), device="cpu")
    want = jpipeline.decode_capture_overlap(iq, JConfig(**cfg))
    assert got == want and len(got[0]) > 20


# The five decodes a key names: (port function, recover2, airjax's call).
VARIANTS = {
    "decode_iq_block": (pipeline.decode_iq_block, False, jpipeline.decode_iq_block),
    "decode_iq_block_r2": (pipeline.decode_iq_block, True, jpipeline.decode_iq_block_r2),
    "decode_iq_block_extended": (pipeline.decode_iq_block_extended, False, jpipeline.decode_iq_block_extended),
    "decode_iq_block_with_fields": (pipeline.decode_iq_block_with_fields, False,
                                    jpipeline.decode_iq_block_with_fields),
    "decode_iq_block_extended_with_fields_r2": (
        pipeline.decode_iq_block_extended_with_fields, True,
        lambda iq, n_off, k: jpipeline.decode_iq_block_extended_with_fields(iq, n_off, k, recover2=True)),
}
N_SAMPLES, N_OFF, K = 24000, 24000 - 240, 32


def _variant_iq(seed: int) -> np.ndarray:
    """A DF17 frame clean, with a 2-bit flip and with a 1-bit flip, then
    five frames of other formats."""
    df17 = synth.make_df17(0xC00000 + seed, synth.make_id_me("VAR"))
    frames = [df17, synth.flip_bit(synth.flip_bit(df17, 30), 70), synth.flip_bit(df17, 40)]
    frames += synth.make_mixed_frames(2, seed)[:5]
    return synth.modulate(frames, [300 + 2900 * i for i in range(len(frames))], N_SAMPLES, seed=seed)


def _eager(fn, recover2: bool, iq: torch.Tensor) -> dict:
    return fn(iq, N_OFF, K, recover2=recover2)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_layout_equals_the_eager_dict(variant):
    """dict_layout covers both buffers once; the plain dict written into
    them and read back through layout_views, as torch views and as numpy
    arrays, is the eager dict, dtypes included; and a BlockGraphs fetch of
    the same block, eager then replayed, is airjax's dict."""
    fn, recover2, jfn = VARIANTS[variant]
    gate, extended, fields = pipeline._GRAPH_DECODES[fn]
    lay = block_decode.dict_layout(K, extended, recover2, fields)
    cover = {"i": np.zeros(lay.n_int, int), "b": np.zeros(lay.n_byte, int)}
    for _, buf, start, shape, _ in lay.entries:
        cover[buf][start : start + math.prod(shape)] += 1
    assert all((c == 1).all() for c in cover.values())

    iq = _variant_iq(80)
    t = torch.as_tensor(iq)
    eager = pipeline.to_host(_eager(fn, recover2, t))
    ints, byts = torch.zeros(lay.n_int, dtype=torch.int32), torch.zeros(lay.n_byte, dtype=torch.uint8)
    block_decode.decode_block_bits_into(*magdet_bits(t, N_OFF, gate=gate), N_OFF, K, ints, byts,
                                        extended=extended, recover2=recover2, fields=fields)
    for views in (pipeline.to_host(layout_views(lay.entries, ints, byts)),
                  layout_views(lay.entries, ints.numpy().copy(), byts.numpy().copy())):
        _same_tree(eager, views)
        for key, v in views.items():
            if not isinstance(v, dict):
                assert v.dtype == eager[key].dtype, key

    want = jfn(jnp.asarray(iq), N_OFF, K)
    graphs = pipeline.BlockGraphs(fn, recover2=recover2, device="cpu", depth=0)
    for _ in range(3):  # eager, then the slot's capture and replay, then a replay
        slot = graphs.dispatch(iq, N_OFF, K)
        _same_tree(want, graphs.fetch(slot))
        graphs.done(slot)
    assert (graphs.eager, graphs.captures, graphs.replays) == (1, 1, 2)


def test_slots_in_flight_beyond_the_ring_raise():
    """depth + 1 slots a key: a decode more in flight than that would
    overwrite one, and raises instead; a fetched, done slot is taken again."""
    iq = _variant_iq(81)
    graphs = pipeline.BlockGraphs(pipeline.decode_iq_block, device="cpu", depth=1)
    a, b = graphs.dispatch(iq, N_OFF, K), graphs.dispatch(iq, N_OFF, K)
    assert a is not b
    with pytest.raises(RuntimeError, match="in flight"):
        graphs.dispatch(iq, N_OFF, K)
    graphs.fetch(a), graphs.done(a)
    assert graphs.dispatch(iq, N_OFF, K) is a


def test_keys_are_bounded():
    """At most MAX_GRAPH_SHAPES keys; the least recently used goes, and
    its shape runs eagerly when it comes back."""
    graphs = pipeline.BlockGraphs(pipeline.decode_iq_block, device="cpu", depth=0)
    iq = _variant_iq(82)
    lengths = [N_SAMPLES - 16 * i for i in range(pipeline.MAX_GRAPH_SHAPES + 1)] + [N_SAMPLES]
    for n in lengths:
        slot = graphs.dispatch(iq[:n], n - 240, K)
        graphs.fetch(slot), graphs.done(slot)
    assert len(graphs.slots()) == pipeline.MAX_GRAPH_SHAPES  # one slot a key at depth 0
    assert graphs.eager == len(lengths) and graphs.replays == 0


@pytest.mark.cuda
@pytest.mark.parametrize("upload", [True, False])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_replay_equals_the_eager_wrappers_on_the_card(variant, upload, cuda_device):
    """On the card: a replay's dict is the eager wrappers' bit for bit, on
    a block other than the one the slot was captured after, and each
    replay adds one front and one block-decode launch (with F where
    batched) to the wrappers' counts."""
    fn, recover2, _ = VARIANTS[variant]
    fields = pipeline._GRAPH_DECODES[fn][2]
    blocks = [_variant_iq(90 + i) for i in range(3)]
    graphs = pipeline.BlockGraphs(fn, recover2=recover2, device=cuda_device, depth=0, upload=upload)
    for i, iq in enumerate(blocks + blocks[:1]):
        dev = torch.as_tensor(iq, device=cuda_device)
        want = pipeline.to_host(_eager(fn, recover2, dev))
        before = (magdet.bits_launches, block_decode.launches, block_decode.fields_launches)
        slot = graphs.dispatch(iq if upload else dev, N_OFF, K)
        got = graphs.fetch(slot)
        graphs.done(slot)
        after = (magdet.bits_launches, block_decode.launches, block_decode.fields_launches)
        _same_tree(want, got)
        assert tuple(a - b for a, b in zip(after, before)) == (1, 1, int(fields)), i
    assert (graphs.eager, graphs.captures, graphs.replays) == (1, 1, 3)
