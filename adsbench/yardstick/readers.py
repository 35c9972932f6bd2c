"""What the per-layer metric readers share: a stage's host time a block
over the window, the device's idle share, a kernel's share of its
roofline. Each returns None where the run holds nothing to read."""

from __future__ import annotations

from adsbench.yardstick import bounds


def stage_ms(run, name: str) -> float | None:
    total, calls = run.stages.get(name, (0.0, 0))
    return 1e3 * total / calls if calls else None


def idle_pct(run) -> float | None:
    if run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])


def kernel_time(run, key: str) -> tuple[int, float]:
    count, total = 0, 0.0
    for name, (c, t) in run.trace["kernels"].items():
        if key in name:
            count, total = count + c, total + t
    return count, total


def roofline_pct(run, key: str, bytes_a_launch: float) -> float | None:
    if run.trace is None:
        return None
    count, total = kernel_time(run, key)
    if not count or total <= 0:
        return None
    return 100.0 * count * bounds.bound_s(bytes_a_launch) / total
