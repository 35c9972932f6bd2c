"""One run of one cell: the sky from the seed, the receiver built as its
configuration says, the blocks driven through the program's stream
runner, the window timed, and the result compared with the reference.

Everything that belongs to one cell is found by name: BENCHMARK.json
names the cell's configuration (its file under `configs/`) and traffic
(`traffic/<name>.json`); the configuration names the program's entry
(`entries/<entry>.py`: the call the window drives, the counters that
open the window, the comparison) and its sink (`sinks/<kind>.py`); each
metric is a reader `metrics/<name>.py`, or for a name `<quantity>.<split>`
without a file of its own `metrics/<quantity>.py`, whose `read(run)`
returns a number or None. A new cell, configuration, entry, traffic mix
or metric is new files and a new entry in BENCHMARK.json, with no file
here edited.

The window. The drive feeds the capture's first blocks before the window
opens (as many as the entry asks: for the stream, enough that its one
block shape has been run eagerly once and each slot's graph captured);
the window opens when the entry's counters say the warm-up is done. A
closed drive hands the next block over as soon as the runner asks for
it and stops asking after the window's seconds; an open drive makes
block j due at the window's open plus j blocks of the receiver's sample
rate, sleeps until then, and ends the window when the next block would
be due after its seconds. The window closes when the runner returns, every block it
was handed decoded and applied.

The latency (open drives) runs from the due time of a message's block to
the return of the sink call that received it, the drive's late wake-up
included. The drive stamps each block's hand-over, just before it yields
the block: `drive_late_ms` reads how late it ran, and the log line gives
the share of blocks the program was behind at (`behind_at_due`), so a
reader can tell a late drive from a program that fell behind.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np

BANNED_MODULES = ("jax", "jaxlib", "flax", "airjax")


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(f"adsbench_{path.parent.name}_{path.stem}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def banned_modules() -> list[str]:
    """Top-level names of loaded modules that the run may not hold."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(BANNED_MODULES))


class Bench:
    """BENCHMARK.json and the files it names, under the checkout `root`."""

    def __init__(self, root: Path):
        self.root = Path(root)
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())
        self.dir = self.root / "adsbench"

    def cell(self, name: str) -> dict:
        for cell in self.spec["workloads"]:
            if cell["name"] == name:
                return cell
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, cell: dict) -> dict:
        for config in self.spec["configs"]:
            if config["name"] == cell["config"]:
                return json.loads((self.root / config["file"]).read_text())
        raise KeyError(f"no config {cell['config']!r} in BENCHMARK.json")

    def traffic(self, cell: dict) -> dict:
        return json.loads((self.dir / "traffic" / f"{cell['traffic']}.json").read_text())

    def sink(self, kind: str):
        return load_module(self.dir / "sinks" / f"{kind}.py")

    def entry(self, name: str):
        return load_module(self.dir / "entries" / f"{name}.py")

    def reader(self, metric: str):
        """`metrics/<name>.py`, or for a name split by the end-to-end
        metric it moves (`apply_ms.live`), the reader of the quantity
        (`metrics/apply_ms.py`)."""
        path = self.dir / "metrics" / f"{metric}.py"
        if not path.exists() and "." in metric:
            path = self.dir / "metrics" / f"{metric.rsplit('.', 1)[0]}.py"
        return load_module(path)

    def metrics(self, cell_name: str, traced: bool) -> list[dict]:
        """The cell's end-to-end metrics, or with `traced` its per-layer ones."""
        e2e = [m for m in self.spec["end_to_end"] if cell_name in m.get("workloads", [cell_name])]
        if not traced:
            return e2e
        moves = {m["name"] for m in e2e}
        return [m for m in self.spec["per_layer"]
                if (cell_name in m["workloads"] if "workloads" in m else m["moves"] in moves)]


class Drive:
    """The source the runner reads, on its prefetch thread (module
    docstring). `pace_hz` None is a closed drive."""

    def __init__(self, iq: np.ndarray, block: int, warm_blocks: int, pace_hz: float | None, seconds: float,
                 ready, on_open, on_close):
        if len(iq) % block:
            raise ValueError(f"a capture of {len(iq)} samples is no whole number of {block}-sample blocks")
        self.iq, self.block, self.warm = iq, block, warm_blocks
        self.pace_hz, self.seconds = pace_hz, seconds
        self.ready, self.on_open, self.on_close = ready, on_open, on_close
        self.due: list[float] = []
        self.released: list[float] = []  # each window block's hand-over
        self.slept: list[bool] = []  # whether the drive slept until the block was due
        self.waits: list[tuple[float, float]] = []
        self.t0 = None

    def _block(self, k: int) -> np.ndarray:
        i = k % (len(self.iq) // self.block)
        return self.iq[i * self.block : (i + 1) * self.block]

    def __iter__(self):
        k = 0
        for _ in range(self.warm):
            yield self._block(k)
            k += 1
        self.ready()
        self.t0 = t0 = time.perf_counter()
        self.on_open()
        period = None if self.pace_hz is None else self.block / self.pace_hz
        j = 0
        while True:
            now = time.perf_counter()
            if period is None:
                due = now
                if due - t0 >= self.seconds:
                    break
            else:
                due = t0 + j * period
                if due - t0 >= self.seconds:
                    break
                if due > now:
                    time.sleep(due - now)
                    self.waits.append((now, time.perf_counter()))
            self.due.append(due)
            self.slept.append(due > now)
            self.released.append(time.perf_counter())
            yield self._block(k)
            k += 1
            j += 1
        self.on_close()


def behind_at_due(due, slept, message_blocks, message_ends) -> np.ndarray:
    """Whether the program was behind at each window block's due time: the
    drive did not sleep until the block was due, or a message of a block
    before it returned from the sink after that time. `message_blocks` are
    the messages' window blocks (below 0 for the warm-up's), `message_ends`
    their sink calls' returns."""
    due = np.asarray(due, np.float64)
    n = len(due)
    # done[j]: the last return of a message of the blocks before j.
    done = np.full(n, -np.inf)
    after = np.asarray(message_blocks, np.int64) + 1
    keep = after < n
    np.maximum.at(done, np.maximum(after[keep], 0), np.asarray(message_ends, np.float64)[keep])
    done = np.maximum.accumulate(done)
    return ~np.asarray(slept, bool) | (done > due)


@dataclasses.dataclass
class RunView:
    """What a metric reader reads (each returns None where a field it
    needs is None)."""

    setup_s: float
    window_s: float
    samples: int
    blocks: int
    stages: dict  # stage -> (seconds, calls) over the window
    latencies_s: np.ndarray | None
    detections_a_block: float
    block_shape: tuple[int, int]  # (samples a dispatched block, offsets scanned)
    extended: bool
    fields: bool
    trace: dict | None
    drive_late_s: np.ndarray | None = None  # each window block's hand-over less its due time (open drives)


def host_clocks() -> dict:
    """The process's CPU seconds (every thread), the main thread's, its
    involuntary context switches, and the host's steal and total jiffies
    (/proc/stat, where there is one)."""
    import resource
    import threading

    main = time.clock_gettime(time.pthread_getcpuclockid(threading.main_thread().ident))
    clocks = {"cpu_s": time.process_time(), "main_cpu_s": main,
              "nivcsw": resource.getrusage(resource.RUSAGE_SELF).ru_nivcsw, "steal": 0, "jiffies": 0}
    try:
        with open("/proc/stat") as f:
            ticks = [int(x) for x in f.readline().split()[1:]]
        clocks.update(steal=ticks[7] if len(ticks) > 7 else 0, jiffies=sum(ticks))
    except OSError:
        pass
    return clocks


class GcSpans:
    """The collector's pauses, from gc.callbacks: (start, end) of each
    collection of the oldest generation and of any other that took a
    millisecond or more."""

    def __init__(self):
        self.spans: list[tuple[float, float]] = []
        self._t0 = 0.0

    def __call__(self, phase: str, info: dict) -> None:
        t = time.perf_counter()
        if phase == "start":
            self._t0 = t
        elif info["generation"] == 2 or t - self._t0 >= 1e-3:
            self.spans.append((self._t0, t))

    def inside(self, t0: float, t1: float) -> tuple[int, float, float]:
        """(collections, seconds, longest) inside [t0, t1]."""
        d = [b - a for a, b in self.spans if a >= t0 and b <= t1]
        return len(d), sum(d), max(d, default=0.0)


def run_cell(bench: Bench, cell_name: str, seed: int, seconds: float, traced: bool, device: str,
             t_start: float, decode_overrides: dict | None = None) -> dict:
    """One run -> the result line's fields (`checks` last), plus `log`
    lines for standard error."""
    import gc

    import torch

    from adsbench.yardstick import record, trace, traffic

    cell = bench.cell(cell_name)
    config = bench.config(cell)
    mix = bench.traffic(cell)
    decode = {**config["decode"], **(decode_overrides or {})}
    receiver = config["receiver"]
    block = int(receiver["block_samples"])
    rate = float(receiver["sample_rate_hz"])
    cuda = torch.device(device).type == "cuda"

    sky = traffic.make_sky(mix["sky"], seed, rate, device)
    drive_spec = mix["drive"]
    pace_hz = float(drive_spec["samples_per_s"]) if drive_spec["loop"] == "open" else None

    program = bench.entry(config["entry"]).Entry(config, decode, device)
    sinkmod = bench.sink(config["sink"]["kind"])
    recorder = record.Recorder()
    sink, display = sinkmod.build({**config, "decode": decode}, recorder)
    opened: dict = {}
    gc_spans = GcSpans()

    def mark():
        if traced and cuda:
            torch.cuda._sleep(100)

    def on_open():
        opened.update(program.snapshot(), clocks=host_clocks())
        mark()

    drive = Drive(sky.iq, block, program.warm_blocks, pace_hz, seconds, program.ready, on_open, mark)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    gc.callbacks.append(gc_spans)
    prof = None
    try:
        if traced and cuda:
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                program.run(drive, sink)
                torch.cuda.synchronize()
        else:
            program.run(drive, sink)
        t_end = time.perf_counter()
        clocks = host_clocks()
    finally:
        gc.callbacks.remove(gc_spans)
    if drive.t0 is None:
        raise RuntimeError("the window never opened")
    closed = program.snapshot()
    if closed["counters"] != opened["counters"]:
        raise RuntimeError(f"the program built or captured inside the window: {opened['counters']} -> "
                           f"{closed['counters']}")
    memory_peak = int(torch.cuda.max_memory_allocated()) if cuda else 0

    n_blocks = len(drive.due)
    window_s = t_end - drive.t0
    stages = {k: (v[0] - opened["stages"].get(k, (0.0, 0))[0], v[1] - opened["stages"].get(k, (0.0, 0))[1])
              for k, v in closed["stages"].items()}
    d_blocks = closed["blocks"] - opened["blocks"]
    detections_a_block = (closed["detections"] - opened["detections"]) / d_blocks if d_blocks else 0.0
    summary = None
    if prof is not None:
        summary = trace.summarize(trace.device_ops(prof.events()), drive.t0,
                                  {"track / ui: the sink": recorder.sink_spans(),
                                   "source: waiting for the block to be due": list(drive.waits),
                                   "runner: the garbage collector": gc_spans.spans})
        del prof
    program_table = sinkmod.table(display)
    del sink, display

    # The reference, after the window and the peak.
    n_stream = (program.warm_blocks + n_blocks) * block
    iq_dev = torch.as_tensor(sky.iq, device=device)
    loop = program.reference(iq_dev)
    del iq_dev
    numbers, facts = program.check(recorder, loop, len(sky.iq), n_stream, program_table, set(sky.aircraft))

    latencies = drive_late = None
    open_log = ""
    if pace_hz is not None:
        j = facts["message_blocks"] - program.warm_blocks
        ends = facts["message_ends"]
        timed = (j >= 0) & (j < n_blocks)
        latencies = ends[timed] - np.asarray(drive.due)[j[timed]]
        drive_late = np.asarray(drive.released) - np.asarray(drive.due)
        if n_blocks:
            behind = behind_at_due(drive.due, drive.slept, j, ends)
            open_log = (f"; drive late median {1e3 * np.median(drive_late):.6f} ms, p95 "
                        f"{1e3 * np.percentile(drive_late, 95):.6f} ms; blocks behind at due "
                        f"{int(behind.sum())} of {n_blocks}, share {behind.mean():.6f}")

    view = RunView(
        setup_s=drive.t0 - t_start, window_s=window_s, samples=n_blocks * block, blocks=n_blocks,
        stages=stages, latencies_s=latencies, drive_late_s=drive_late, detections_a_block=detections_a_block,
        block_shape=program.block_shape, extended=bool(decode["extended"]),
        fields=bool(config["sink"]["batched"]), trace=summary,
    )
    metrics = {}
    for m in bench.metrics(cell_name, traced):
        value = bench.reader(m["name"]).read(view)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
        "count": int(cell["chips"]),
        "memory_peak_bytes": memory_peak,
    }
    if summary is not None:
        dev.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
    n_gc, gc_s, gc_max = gc_spans.inside(drive.t0, t_end)
    d = {k: clocks[k] - opened["clocks"][k] for k in clocks}
    log = [f"{program.log()}; window blocks {n_blocks}, packets {recorder.n_packets}, "
           f"block calls {len(recorder.blocks)}, stages {stages}; collector pauses in the window "
           f"{n_gc}, {gc_s:.6f} s, longest {gc_max:.6f} s; window {window_s:.6f} s, CPU {d['cpu_s']:.6f} s, "
           f"main thread {d['main_cpu_s']:.6f} s, involuntary switches {d['nivcsw']}, "
           f"host steal {d['steal'] / max(d['jiffies'], 1):.6f}{open_log}"]
    result = result_line(numbers, facts, metrics, dev, summary)
    result["log"] = log
    return result


def result_line(numbers: dict, facts: dict, metrics: dict, device: dict, summary: dict | None) -> dict:
    """The result's keys in their order: the verdict, the counts, the
    metrics, the device, the trace's breakdown where traced, and last the
    numbers compared with their limits."""
    from adsbench.yardstick import check

    result = {
        "correct": check.verdict(numbers),
        "attempted": int(facts["attempted"]),
        "failed": int(facts["failed"]),
        "metrics": metrics,
        "device": device,
    }
    if summary is not None:
        result["breakdown"] = {"device_ops": summary["device_ops"], "idle_gaps": summary["idle_gaps"]}
    result["checks"] = {k: {"value": v, "limit": check.LIMITS[k]} for k, v in numbers.items()}
    return result
