"""Observability (airjax/observability.py, which imports jax): a profiler
trace of a run, host-side stage timing, and one-line structured stat logs.

  * `trace(...)`   — torch.profiler around a block: host ops and, where a
                     card is present, the card's kernels and copies; written
                     as a Chrome trace (chrome://tracing, ui.perfetto.dev)
                     into the directory given (`adsb --trace DIR`), with
                     the stages' spans recorded meanwhile (`SpanLog`) on
                     tracks of their own
  * `StageTimer`   — wall-clock per named stage; the stream runner's
                     stages are source, carry, dispatch, hold, fetch,
                     apply and sink (runner.StreamStats), each span also
                     kept while a trace is active
  * `log_stats`    — `<event> <JSON of the stats, keys sorted>` at INFO
"""

from __future__ import annotations

import collections
import contextlib
import json
import logging
import os
import threading
import time

import torch

logger = logging.getLogger("airjax_torch")

# The active trace's span log, or None: the one switch StageTimer.add
# tests. trace() sets it for its block; a caller may set a SpanLog of its
# own to record spans without a profiler.
recording: SpanLog | None = None

# The span tracks' thread ids: above any the OS hands out, so that no
# span shares a track with the profiler's own events.
_SPAN_TID = 1 << 30


class SpanLog:
    """The stages' spans, bounded: (name, thread, start, end, block,
    parent), start and end on time.perf_counter, `block` the sequence
    number all of one block's spans share, `parent` the name of the stage
    the span nests in. Keeps the newest `capacity`; `dropped` counts the
    older spans let go."""

    def __init__(self, capacity: int = 1 << 18):
        self.spans: collections.deque = collections.deque(maxlen=capacity)
        self.dropped = 0

    def add(self, name: str, start: float, end: float, block: int | None = None, parent: str | None = None,
            thread: str | None = None) -> None:
        if len(self.spans) == self.spans.maxlen:
            self.dropped += 1
        self.spans.append((name, thread or threading.current_thread().name, start, end, block, parent))

    def chrome_events(self, to_us, pid: int) -> list[dict]:
        """The spans as Chrome trace events in process `pid`, `to_us`
        taking a perf_counter second to the trace's µs. A thread's spans go
        on its track where they nest; one that overlaps a span of its track
        without nesting in it (a block's hold, which ends after the next
        block's begins) goes on the thread's next track where it nests."""
        threads: dict[str, list] = collections.defaultdict(list)
        for span in self.spans:
            threads[span[1]].append(span)
        events = []
        for k, (thread, spans) in enumerate(threads.items()):
            open_ends: list[list[float]] = []  # a track's open spans' ends, innermost last
            for name, _, start, end, block, parent in sorted(spans, key=lambda s: (s[2], -s[3])):
                for lane, ends in enumerate(open_ends):
                    while ends and ends[-1] <= start:
                        ends.pop()
                    if not ends or end <= ends[-1]:
                        break
                else:
                    lane, ends = len(open_ends), []
                    open_ends.append(ends)
                ends.append(end)
                ts = round(to_us(start), 3)
                events.append({"ph": "X", "cat": "airjax_torch", "name": name, "pid": pid,
                               "tid": _SPAN_TID + 64 * k + lane, "ts": ts, "dur": round(round(to_us(end), 3) - ts, 3),
                               "args": {"block": block, "parent": parent, "thread": thread}})
            for lane in range(len(open_ends)):
                tid = _SPAN_TID + 64 * k + lane
                label = f"{thread} spans" + (f" ({lane + 1})" if lane else "")
                events += [{"ph": "M", "name": "thread_name", "pid": pid, "tid": tid, "args": {"name": label}},
                           {"ph": "M", "name": "thread_sort_index", "pid": pid, "tid": tid,
                            "args": {"sort_index": tid}}]
        return events


def _wall_less_perf_ns() -> int:
    """time.time_ns less time.perf_counter_ns, read between two
    perf_counter readings: both clocks run at the same rate, so one pair
    converts a whole trace."""
    p0 = time.perf_counter_ns()
    wall = time.time_ns()
    p1 = time.perf_counter_ns()
    return wall - (p0 + p1) // 2


def _add_spans(path: str, spans: SpanLog, wall_less_perf: int) -> None:
    """Write the spans into the Chrome trace at `path`, on its clock: the
    export stamps `ts` as wall-clock µs less `baseTimeNanoseconds`."""
    with open(path) as f:
        doc = json.load(f)
    rel = wall_less_perf - doc.get("baseTimeNanoseconds", 0)  # an int: wall-clock ns are past float64's exact range

    def to_us(t: float) -> float:
        return (t * 1e9 + rel) * 1e-3

    doc["traceEvents"] += spans.chrome_events(to_us, os.getpid())
    doc["airjax_torch_spans"] = {"kept": len(spans.spans), "dropped": spans.dropped}
    with open(path, "w") as f:
        json.dump(doc, f)


@contextlib.contextmanager
def trace(log_dir: str = "/tmp/airjax_trace", enabled: bool = True):
    """Profile the enclosed block (airjax :28-42) into
    `log_dir`/airjax_torch.<pid>.<ns>.pt.trace.json; the CUDA activity is
    recorded when a card is present, and the stages' spans (`recording`)
    are written into the same trace on its clock. enabled=False does
    nothing."""
    global recording
    if not enabled:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    outer, spans = recording, SpanLog()
    with torch.profiler.profile(activities=activities) as prof:
        wall_less_perf = _wall_less_perf_ns()
        recording = spans
        try:
            yield
        finally:
            recording = outer
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    path = os.path.join(log_dir, f"airjax_torch.{os.getpid()}.{time.time_ns()}.pt.trace.json")
    prof.export_chrome_trace(path)
    if spans.spans:
        _add_spans(path, spans, wall_less_perf)
    logger.info("profile written to %s (%d spans, %d dropped)", path, len(spans.spans), spans.dropped)


class StageTimer:
    """Accumulates wall-clock per named stage; cheap enough to be always on.
    While a SpanLog is `recording`, a stage given its `start` is also kept
    as a span, with its block's sequence number."""

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str, *, block: int | None = None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - t0, start=t0, block=block)

    def add(self, name: str, dt: float, *, start: float | None = None, block: int | None = None,
            thread: str | None = None) -> None:
        # counts before totals: a concurrent as_dict never sees a total
        # without its count.
        self.counts[name] = self.counts.get(name, 0) + 1
        self.totals[name] = self.totals.get(name, 0.0) + dt
        log = recording
        if log is not None and start is not None:
            log.add(name, start, start + dt, block, thread=thread)

    def as_dict(self) -> dict:
        totals, counts = dict(self.totals), dict(self.counts)
        return {
            name: {
                "total_s": round(total, 6),
                "calls": counts[name],
                "mean_ms": round(total / counts[name] * 1e3, 3),
            }
            for name, total in sorted(totals.items())
        }


def log_stats(event: str, stats: dict, level: int = logging.INFO) -> None:
    """One structured line: the event, then the stats as JSON (airjax :84-86)."""
    logger.log(level, "%s %s", event, json.dumps(stats, sort_keys=True))
