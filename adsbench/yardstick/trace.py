"""Device time from the profiler's trace of a run: the window between
the two marker kernels the drive launches at the window's open and
close, the union of the device's operations inside it, the time by
kernel, and the idle gaps named by what the host was doing."""

from __future__ import annotations

import bisect
import collections

MARKER = "spin_kernel"  # torch.cuda._sleep's kernel, launched only by the drive


def device_ops(events) -> list[tuple[str, float, float]]:
    """(name, start s, end s) of the profiler's device events."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    return sorted((e.name, e.time_range.start * 1e-6, e.time_range.end * 1e-6)
                  for e in events if e.device_type == cuda)


def union(intervals: list[tuple[float, float]]) -> float:
    busy, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    return busy


def overlap(spans: list[tuple[float, float]], starts: list[float], a: float, b: float) -> float:
    """Seconds of [a, b] that the sorted, disjoint `spans` cover."""
    i = max(bisect.bisect_right(starts, a) - 1, 0)
    got = 0.0
    while i < len(spans) and spans[i][0] < b:
        got += max(0.0, min(b, spans[i][1]) - max(a, spans[i][0]))
        i += 1
    return got


def summarize(ops: list[tuple[str, float, float]], host_t0: float, host_spans: dict[str, list]) -> dict:
    """The window's device facts. `host_spans` names lists of host
    (start, end) perf_counter spans; a gap is named by the one that covers
    most of it, else "runner / pipeline"."""
    marks = [op for op in ops if MARKER in op[0]]
    if len(marks) < 2:
        raise RuntimeError(f"the trace holds {len(marks)} window markers, not 2")
    w0, w1 = marks[0][1], marks[-1][1]
    inside = [(n, max(a, w0), min(b, w1)) for n, a, b in ops if MARKER not in n and b > w0 and a < w1]
    by_name: dict[str, list] = collections.defaultdict(lambda: [0, 0.0])
    for n, a, b in inside:
        by_name[n][0] += 1
        by_name[n][1] += b - a
    gaps, end = [], w0
    for _, a, b in sorted(inside, key=lambda x: x[1]):
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    if w1 > end:
        gaps.append((end, w1))
    shift = host_t0 - w0  # device time -> host perf_counter time
    spans = {k: sorted(v) for k, v in host_spans.items()}
    starts = {k: [s[0] for s in v] for k, v in spans.items()}
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    named = []
    for a, b in longest:
        cover = {k: overlap(spans[k], starts[k], a + shift, b + shift) for k in spans}
        best = max(cover, key=cover.get) if cover else None
        name = best if best is not None and cover[best] > 0.5 * (b - a) else "runner / pipeline"
        named.append([f"{name} at +{a - w0:.6f} s", b - a])
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    return {
        "window_s": w1 - w0,
        "busy_s": union([(a, b) for _, a, b in inside]),
        "kernels": {n: (c, t) for n, (c, t) in by_name.items()},
        "device_ops": [[n, t] for n, (_, t) in top],
        "idle_gaps": named,
    }
