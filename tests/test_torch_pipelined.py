"""airjax_torch.runner.run_stream with decodes in flight (pipeline_depth,
prefetch_depth) against airjax's run_stream at the same depth on the CPU:
overlap and parity modes, per packet and batched, extended, recover2, and a
forced capacity regrow, and a source with no block ready (each decode
fetched right after its dispatch). The packets (their wall-clock stamps
aside), the trackers' tables and the stats (the stage timings aside) are
equal, and the same at every depth. pipeline.Fetcher's stream form runs
on a card only (tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch

from airjax import runner as jrunner
from airjax.config import PipelineConfig as JConfig
from airjax.track import batch as jbatch
from airjax_torch import pipeline, runner
from airjax_torch.config import PipelineConfig
from airjax_torch.io import synth
from airjax_torch.io.source import Prefetcher
from airjax_torch.track import batch as tbatch
from test_torch_track import state
from torch_parity import packet_fields

DEPTHS = (0, 1, 2, 4)
CHUNK = 20000


def _stream(seed: int, extended: bool = False, flips: bool = False, n_blocks: int = 5, per_block: int = 6):
    """n_blocks 20,000-sample blocks and a ragged tail: per block frames on
    a grid and one across the block's end; every format with extended,
    every fourth DF17 with a 2-bit flip with flips (a recover2 repair,
    after its ICAO was seen clean)."""
    rng = np.random.default_rng(seed)
    n = n_blocks * CHUNK + 7000
    offsets, frames = [], []
    pool = synth.make_mixed_frames(3, seed) if extended else [
        synth.make_df17(0xA00000 + i, synth.make_id_me(f"PIPE{i:04d}")) for i in range(3)]
    for b in range(n_blocks):
        for k in range(per_block):
            offsets.append(b * CHUNK + 300 + k * 2900 + int(rng.integers(0, 200)))
        offsets.append((b + 1) * CHUNK - 120)  # across the block's end
    for i, _ in enumerate(offsets):
        f = pool[i % len(pool)]
        if flips and i % 4 == 3 and i >= len(pool) and f[0] >> 3 == 17:
            f = synth.flip_bit(synth.flip_bit(f, 30), 70)
        frames.append(f)
    iq = synth.modulate(frames, offsets, n, noise_std=30.0, seed=seed)
    return lambda: (iq[i : i + CHUNK] for i in range(0, n, CHUNK))


def _view(p) -> tuple:
    name, fields = packet_fields(p)
    return name, {k: v for k, v in fields.items() if k != "time_processed"}


def _stats(stats) -> dict:
    return {k: v for k, v in stats.as_dict().items() if k not in ("stages", "msamples_per_s")}


# (mode, run_stream kwargs, a batched sink class of each package or None, stream kwargs)
MODES = {
    "overlap": ({}, None, {}),
    "parity": ({"overlap": False}, None, {}),
    "batched": ({}, (jbatch.BatchTracker, tbatch.BatchTracker), {}),
    "recover2": ({"recover2": True}, None, {"flips": True}),
    "recover2_batched": ({"recover2": True}, (jbatch.BatchTracker, tbatch.BatchTracker), {"flips": True}),
    "extended": ({"extended": True}, None, {"extended": True}),
    "extended_batched": ({"extended": True}, (jbatch.ExtendedBatchTracker, tbatch.ExtendedBatchTracker),
                         {"extended": True}),
    "extended_recover2": ({"extended": True, "recover2": True}, None, {"extended": True, "flips": True}),
}


def _run_both(blocks, kw: dict, sinks, depth: int, prefetch: int = 4, cfg=None, idle: bool = False):
    """The stream through both packages at `depth` -> (the port's packets or
    table, its stats), each asserted equal to airjax's. `idle`: the port's
    source never has a block ready, so every decode is fetched right after
    its dispatch."""
    cfg_kw = {} if cfg is None else {"cfg": cfg[1]}
    jcfg_kw = {} if cfg is None else {"cfg": cfg[0]}
    if sinks is None:
        got, want = [], []
        t_stats = runner.run_stream(blocks(), got.append, device="cpu", pipeline_depth=depth,
                                    prefetch_depth=prefetch, **kw, **cfg_kw)
        j_stats = jrunner.run_stream(blocks(), want.append, pipeline_depth=depth, prefetch_depth=prefetch,
                                     **kw, **jcfg_kw)
        got, want = [_view(p) for p in got], [_view(p) for p in want]
    else:
        j_sink, t_sink = sinks[0](), sinks[1]()
        t_stats = runner.run_stream(blocks(), t_sink, device="cpu", pipeline_depth=depth, prefetch_depth=prefetch,
                                    **kw, **cfg_kw)
        j_stats = jrunner.run_stream(blocks(), j_sink, pipeline_depth=depth, prefetch_depth=prefetch,
                                     **kw, **jcfg_kw)
        got, want = (state(t_sink.aircrafts), t_sink.n_messages), (state(j_sink.aircrafts), j_sink.n_messages)
    assert got == want
    assert _stats(t_stats) == _stats(j_stats)
    assert set(t_stats.as_dict()["stages"]) == {"source", "handoff", "carry", "dispatch", "hold", "fetch", "apply",
                                                "sink"}
    assert t_stats.fetches >= t_stats.blocks and t_stats.overlapped == 0  # regrows fetch too
    if idle:
        assert t_stats.early_fetches == t_stats.fetches
    assert t_stats.early_fetches <= t_stats.fetches
    return got, _stats(t_stats)


@pytest.fixture(scope="module")
def serial():
    """Each mode's port result at depth 0, for the depth invariance."""
    return {}


# (mode, depth, idle): every mode at every depth, and DF17 and extended at
# depths 1 and 2 with the port's source never ready (Prefetcher.ready
# forced false: no decode held for the next block).
CASES = [(mode, depth, False) for mode in MODES for depth in DEPTHS] + [
    (mode, depth, True) for mode in ("overlap", "extended") for depth in (1, 2)]


@pytest.mark.parametrize("mode, depth, idle", CASES, ids=[f"{m}-{d}" + "-idle" * i for m, d, i in CASES])
def test_run_stream_at_depth_equals_airjax(mode, depth, idle, serial, monkeypatch):
    if idle:
        monkeypatch.setattr(Prefetcher, "ready", lambda self: False)
    kw, sinks, stream_kw = MODES[mode]
    got, stats = _run_both(_stream(11, **stream_kw), kw, sinks, depth, idle=idle)
    assert stats["good"] > 20
    if kw.get("recover2") and not kw.get("extended") and sinks is None:
        assert stats["recovered2"] > 0
    first = serial.setdefault(mode, (got, stats))
    assert (got, stats) == first, f"depth {depth} differs from depth {DEPTHS[0]}"


@pytest.mark.parametrize("prefetch", [1, 4])
@pytest.mark.parametrize("depth", [1, 2])
def test_prefetch_depth_equals_airjax(prefetch, depth):
    got, stats = _run_both(_stream(12), {}, None, depth, prefetch=prefetch)
    assert stats["blocks"] == 6 and len(got) == stats["good"] > 30


@pytest.mark.parametrize("depth", DEPTHS)
def test_forced_regrow_at_depth_equals_airjax(depth):
    """A capacity of 4 against 7 frames a block: every block regrows while
    its successors are in flight."""
    cfg = (JConfig(max_candidates=4), PipelineConfig(max_candidates=4))
    got, stats = _run_both(_stream(13), {}, None, depth, cfg=cfg)
    assert stats["overflow_blocks"] >= 5 and len(got) == stats["good"] > 30


def test_fetcher_on_the_cpu_is_to_host():
    """On the CPU a stage wraps the array, an upload is the array, and a
    fetch is to_host; no overlap is counted."""
    f = pipeline.Fetcher("cpu")
    iq = np.arange(20, dtype=np.int16).reshape(10, 2)
    staged = f.stage(iq)
    assert staged.device.type == "cpu" and f.upload(staged) is staged
    ticket = f.launched(staged)
    assert ticket.event is None and ticket.staging is None
    out = f.fetch({"a": torch.tensor([1, 2]), "b": {"c": torch.tensor(3)}}, ticket)
    f.done(ticket)
    assert out["a"].tolist() == [1, 2] and int(out["b"]["c"]) == 3
    assert (f.fetches, f.overlapped) == (1, 0)
