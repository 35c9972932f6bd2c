"""Host-side stage timing for the stream runner: the `StageTimer` of
airjax/observability.py:45-81 (that module imports jax), with the same
stage names in airjax_torch.runner: dispatch, fetch, apply."""

from __future__ import annotations

import contextlib
import time


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
