"""The runner's stages as spans (airjax_torch.observability.SpanLog): the
main thread's account of a stream, each block's spans in order under one
sequence number, the hold at depths 1 and 0 with a block ready behind
the last and without, nothing kept without a trace, the spans on the
Chrome trace's clock, the operator's counters, and the benchmark's
readers of the new stages."""

import ast
import json
import os
import queue
import statistics
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from airjax_torch import cli, observability
from airjax_torch.io import synth
from airjax_torch.io.source import Prefetcher
from airjax_torch.runner import StreamStats, run_stream, run_stream_sharded
from airjax_torch.ui.web import WebDisplay, _Broadcast

ROOT = Path(__file__).resolve().parents[1]
CHUNK = 20000
N_BLOCKS = 6
MAIN = ("source", "carry", "dispatch", "fetch", "apply")
BLOCK_ORDER = ("handoff", "carry", "dispatch", "hold", "fetch", "apply")


def _blocks() -> list[np.ndarray]:
    frames = [synth.make_df17(0x7C6B30 + i, synth.make_id_me(f"SPAN{i}")) for i in range(N_BLOCKS)]
    iq = synth.modulate(frames, [CHUNK * i + 3000 for i in range(N_BLOCKS)], CHUNK * N_BLOCKS, seed=5)
    return [iq[i * CHUNK : (i + 1) * CHUNK] for i in range(N_BLOCKS)]


@pytest.fixture
def spans(monkeypatch):
    log = observability.SpanLog()
    monkeypatch.setattr(observability, "recording", log)
    return log


def _by_block(log) -> dict[int, dict[str, list]]:
    out: dict[int, dict[str, list]] = {}
    for name, thread, start, end, block, parent in log.spans:
        out.setdefault(block, {}).setdefault(name, []).append((start, end, thread, parent))
    return out


def test_main_thread_stages_fit_in_the_run():
    got = []
    t0 = time.perf_counter()
    stats = run_stream(iter(_blocks()), got.append, device="cpu")
    elapsed = time.perf_counter() - t0
    totals = stats.stages.totals
    assert len(got) == N_BLOCKS and stats.stages.counts["source"] == N_BLOCKS
    assert sum(totals[k] for k in MAIN) <= elapsed
    assert totals["sink"] <= totals["apply"]


def _source_ready(monkeypatch, ready: bool) -> None:
    """The Prefetcher's look at its queue forced to `ready`."""
    monkeypatch.setattr(Prefetcher, "ready", lambda self: ready)


def test_each_block_has_its_spans_in_order_and_holds_the_next(spans, monkeypatch):
    """With a block always ready behind the last, depth 1 holds block k
    over block k+1's carry and dispatch, and nothing is fetched early."""
    _source_ready(monkeypatch, True)
    stats = run_stream(iter(_blocks()), lambda p: None, device="cpu", pipeline_depth=1)
    assert stats.early_fetches == 0
    blocks = _by_block(spans)
    assert sorted(blocks) == list(range(N_BLOCKS))
    for seq, named in blocks.items():
        assert all(len(named[k]) == 1 for k in BLOCK_ORDER), (seq, named.keys())
        starts = [named[k][0][0] for k in BLOCK_ORDER]
        assert starts == sorted(starts), seq
        assert named["handoff"][0][2] == "Prefetcher" and named["fetch"][0][2] == threading.current_thread().name
        assert named["source"][0][1] <= named["carry"][0][0]
        for start, end, _, parent in named.get("sink", []):
            assert parent == "apply" and named["apply"][0][0] <= start <= end <= named["apply"][0][1]
        if seq + 1 < N_BLOCKS:
            nxt = blocks[seq + 1]
            hold_start, hold_end = named["hold"][0][:2]
            assert hold_start <= nxt["carry"][0][0] and nxt["dispatch"][0][1] <= hold_end


def test_no_block_ready_ends_the_hold_before_the_next_block(spans, monkeypatch):
    """With no block ready behind the last, depth 1 fetches each block right
    after its own dispatch, before the next block is received. (The carry
    is the window's 239 samples at the stream's end, so no tail flush.)"""
    _source_ready(monkeypatch, False)
    stats = run_stream(iter(_blocks()), lambda p: None, device="cpu", pipeline_depth=1)
    assert stats.early_fetches == stats.fetches == N_BLOCKS
    blocks = _by_block(spans)
    assert sorted(blocks) == list(range(N_BLOCKS))
    for seq in range(N_BLOCKS - 1):
        named, nxt = blocks[seq], blocks[seq + 1]
        assert all(len(named[k]) == 1 for k in BLOCK_ORDER), (seq, named.keys())
        hold_start, hold_end = named["hold"][0][:2]
        assert named["dispatch"][0][1] <= hold_start <= hold_end <= named["fetch"][0][0]
        assert named["apply"][0][1] <= nxt["handoff"][0][1] <= nxt["carry"][0][0]


def test_a_short_read_with_no_block_ready_ends_the_hold(spans, monkeypatch):
    """A read too short to scan, with no block ready behind it, fetches the
    block held in flight before the next read is received."""
    answers = iter([True, False, False])  # after block 0, the short read, block 2
    monkeypatch.setattr(Prefetcher, "ready", lambda self: next(answers))
    iq = _blocks()[0]
    got = []
    stats = run_stream(iter([iq[:5000], iq[5000:5100], iq[5100:]]), got.append, device="cpu", pipeline_depth=1)
    assert stats.early_fetches == stats.fetches == 2 and len(got) == 1
    blocks = _by_block(spans)
    assert "dispatch" not in blocks[1]
    assert blocks[1]["carry"][0][1] <= blocks[0]["fetch"][0][0]
    assert blocks[0]["apply"][0][1] <= blocks[2]["handoff"][0][1]


# runner -> (a run of it on the CPU, the decodes it fetches before the
# source is read). The sharded runner's steps on one shard of CHUNK + 239
# samples take CHUNK fresh samples each: a block completes a step.
RUNNERS = {
    "run_stream": (lambda source, **kw: run_stream(source, lambda p: None, device="cpu", **kw), 0),
    "run_stream_sharded": (lambda source, **kw: run_stream_sharded(
        source, lambda p: None, n_devices=1, shard_block=CHUNK + 239, device="cpu", **kw), 1),
}


@pytest.mark.parametrize("runner", list(RUNNERS))
def test_a_paced_source_is_fetched_without_a_hold(spans, runner):
    """A source that sleeps between blocks, as a live receiver waits for
    its samples: each block is fetched as soon as it is decoded, by both
    runners (the sharded one's warm-up step is fetched without a hold)."""
    def paced():
        for block in _blocks()[:4]:
            yield block
            time.sleep(0.25)

    run, warm = RUNNERS[runner]
    stats = run(paced(), pipeline_depth=1)
    holds = [end - start for name, _, start, end, _, _ in spans.spans if name == "hold"]
    assert len(holds) == stats.stages.counts["hold"] == stats.fetches - warm == 4
    assert statistics.median(holds) < 5e-3 and stats.early_fetches >= 3


def test_hold_is_about_zero_at_depth_zero(spans):
    stats = run_stream(iter(_blocks()), lambda p: None, device="cpu", pipeline_depth=0)
    holds = [end - start for name, _, start, end, _, _ in spans.spans if name == "hold"]
    fetches = [end - start for name, _, start, end, _, _ in spans.spans if name == "fetch"]
    assert len(holds) == stats.stages.counts["hold"] == N_BLOCKS
    assert statistics.median(holds) < 5e-4 and statistics.median(holds) < statistics.median(fetches)


def test_sharded_stream_times_the_same_stages(spans):
    from airjax_torch.parallel.mesh import make_mesh

    stats = run_stream_sharded(iter(_blocks()), lambda p: None, mesh=make_mesh(2, device="cpu"), shard_block=16384)
    assert set(stats.stages.counts) == {"source", "handoff", "carry", "dispatch", "hold", "fetch", "apply", "sink"}
    assert stats.stages.counts["source"] == N_BLOCKS and stats.backlog_max >= 0
    assert {b for *_, b, _ in spans.spans} <= set(range(N_BLOCKS))


def test_no_span_is_kept_without_a_trace(monkeypatch):
    def refuse(*args, **kw):
        raise AssertionError("a span was kept with no trace active")

    monkeypatch.setattr(observability.SpanLog, "add", refuse)
    assert observability.recording is None
    stats = run_stream(iter(_blocks()), lambda p: None, device="cpu")
    assert stats.stages.counts["apply"] == N_BLOCKS


def test_span_log_is_bounded():
    log = observability.SpanLog(capacity=3)
    for k in range(5):
        log.add("s", float(k), k + 0.5, block=k)
    assert [s[4] for s in log.spans] == [2, 3, 4] and log.dropped == 2


def _trace(log_dir) -> list[dict]:
    (path,) = [os.path.join(root, f) for root, _, files in os.walk(log_dir) for f in files]
    return json.load(open(path))["traceEvents"]


def test_a_span_holds_its_ops_on_the_trace_clock(tmp_path):
    timer = observability.StageTimer()
    with observability.trace(str(tmp_path)):
        torch.arange(1 << 12).sum()  # the profiler's first ops are slow: the span's two are not
        with timer.stage("probe", block=7):
            torch.arange(1 << 12).sum()
    events = _trace(tmp_path)
    (probe,) = [e for e in events if e.get("name") == "probe"]
    warm_sum = min(e["ts"] for e in events if e.get("name") == "aten::sum")
    first = min((e for e in events if e.get("name") == "aten::arange" and e["ts"] > warm_sum), key=lambda e: e["ts"])
    last = max((e for e in events if e.get("name") == "aten::sum"), key=lambda e: e["ts"] + e["dur"])
    end = probe["ts"] + probe["dur"]
    assert probe["args"]["block"] == 7 and probe["ph"] == "X"
    assert probe["ts"] <= first["ts"] <= probe["ts"] + 50
    assert end - 50 <= last["ts"] + last["dur"] <= end


def _nested(track: list[dict]) -> bool:
    """No two events of one track overlap without one holding the other."""
    ends: list[float] = []
    for e in sorted(track, key=lambda e: (e["ts"], -e["dur"])):
        while ends and ends[-1] <= e["ts"]:
            ends.pop()
        if ends and e["ts"] + e["dur"] > ends[-1]:
            return False
        ends.append(e["ts"] + e["dur"])
    return True


def test_trace_around_a_stream_writes_every_blocks_spans(tmp_path):
    with observability.trace(str(tmp_path)):
        run_stream(iter(_blocks()), lambda p: None, device="cpu")
    events = [e for e in _trace(tmp_path) if e.get("cat") == "airjax_torch"]
    for seq in range(N_BLOCKS):
        names = {e["name"] for e in events if e["args"]["block"] == seq}
        assert names >= {"source", *BLOCK_ORDER}, seq
    tracks: dict[int, list] = {}
    for e in events:
        tracks.setdefault(e["tid"], []).append(e)
    assert len(tracks) >= 3 and all(_nested(t) for t in tracks.values())
    assert observability.recording is None


def test_prefetcher_counts_its_backlog():
    blocks = [np.zeros((10, 2), np.int16) for _ in range(4)]
    late = Prefetcher(iter(blocks), depth=4)
    time.sleep(0.2)  # the thread fills the queue before the first receipt
    assert len(list(late)) == 4 and late.backlog_max == 3

    def paced():
        for b in blocks:
            time.sleep(0.01)
            yield b

    waiting = Prefetcher(paced(), depth=4)
    for _ in waiting:
        assert waiting.asked <= waiting.received and waiting.got <= waiting.received
    assert waiting.backlog_max == 0


def test_prefetcher_ready_looks_at_its_queue():
    """False before the source yields; true once a block or the stream's end
    is queued; looking takes nothing."""
    go = threading.Event()
    block = np.zeros((10, 2), np.int16)

    def gated():
        go.wait()
        yield block

    def wait_ready(p):
        deadline = time.perf_counter() + 10.0
        while not p.ready() and time.perf_counter() < deadline:
            time.sleep(0.001)
        return p.ready()

    p = Prefetcher(gated(), depth=4)
    time.sleep(0.05)
    assert not p.ready()
    go.set()
    assert wait_ready(p) and p.ready()
    items = iter(p)
    assert next(items) is block
    assert wait_ready(p)  # the end marker, queued behind the block
    assert list(items) == [] and not p.ready()


def test_broadcast_counts_what_a_lagging_client_lost():
    cast = _Broadcast(depth=1)
    _, q = cast.subscribe()
    for k in range(3):
        cast.send(str(k))
    assert (cast.sent, cast.dropped, q.get_nowait()) == (3, 2, "0")
    with pytest.raises(queue.Empty):
        q.get_nowait()
    display = WebDisplay(quiet=True)
    display.broadcast = cast
    line = cli._stats_line(StreamStats(), display)
    assert list(line)[-4:] == ["backlog_max", "early_fetches", "summaries_sent", "summaries_dropped"]
    assert (line["summaries_sent"], line["summaries_dropped"]) == (3, 2)


def test_cli_line_carries_the_operators_counters(capsys):
    assert cli.main(["adsb", "--synthetic", "2", "--torch-device", "cpu"]) == 0
    line = ast.literal_eval(capsys.readouterr().out.rsplit("\nstats: ", 1)[1])
    assert list(line)[:2] == ["blocks", "samples"] and list(line)[-3:] == ["stages", "backlog_max", "early_fetches"]
    assert line["blocks"] == 2 and line["backlog_max"] in (0, 1) and 0 <= line["early_fetches"] <= 3


def _view(stages: dict, blocks: int = 4):
    from adsbench.harness import RunView

    return RunView(setup_s=1.0, window_s=1.0, samples=0, blocks=blocks, stages=stages, latencies_s=None,
                   detections_a_block=0.0, block_shape=(0, 0), extended=False, fields=False, trace=None)


@pytest.mark.parametrize("metric, stage", [("hold_ms.live", "hold"), ("handoff_ms.live", "handoff"),
                                           ("carry_ms.live", "carry"), ("sink_ms.live", "sink")])
def test_readers_of_the_new_stages(metric, stage):
    from adsbench.harness import Bench

    bench = Bench(ROOT)
    assert metric in {m["name"] for m in bench.metrics("web-df17.busy.live", traced=True)}
    reader = bench.reader(metric)
    # 0.04 s over 5 calls (4 blocks and a tail flush): ms a call, or for
    # the sink ms a window's block.
    want = 10.0 if stage == "sink" else 8.0
    assert reader.read(_view({stage: (0.04, 5), "apply": (0.05, 5)})) == pytest.approx(want)
    assert reader.read(_view({"apply": (0.05, 5)})) is None
