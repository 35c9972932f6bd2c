"""Observability (airjax/observability.py, which imports jax): a profiler
trace of a run, host-side stage timing, and one-line structured stat logs.

  * `trace(...)`   — torch.profiler around a block: host ops and, where a
                     card is present, the card's kernels and copies; written
                     as a Chrome trace (chrome://tracing, ui.perfetto.dev)
                     into the directory given (`adsb --trace DIR`)
  * `StageTimer`   — wall-clock per named stage; the stream runner's
                     stages are dispatch, fetch and apply
  * `log_stats`    — `<event> <JSON of the stats, keys sorted>` at INFO
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import time

import torch

logger = logging.getLogger("airjax_torch")


@contextlib.contextmanager
def trace(log_dir: str = "/tmp/airjax_trace", enabled: bool = True):
    """Profile the enclosed block (airjax :28-42) into
    `log_dir`/airjax_torch.<pid>.<ns>.pt.trace.json; the CUDA activity is
    recorded when a card is present. enabled=False does nothing."""
    if not enabled:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        try:
            yield
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    path = os.path.join(log_dir, f"airjax_torch.{os.getpid()}.{time.time_ns()}.pt.trace.json")
    prof.export_chrome_trace(path)
    logger.info("profile written to %s", path)


class StageTimer:
    """Accumulates wall-clock per named stage; cheap enough to be always on."""

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - t0)

    def add(self, name: str, dt: float) -> None:
        # counts before totals: a concurrent as_dict never sees a total
        # without its count.
        self.counts[name] = self.counts.get(name, 0) + 1
        self.totals[name] = self.totals.get(name, 0.0) + dt

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
