"""The program's stream runner, `airjax_torch.runner.run_stream`, as
`adsb` drives it: the source's blocks through the block graphs
(`pipeline.BlockGraphs`), the dicts fetched and handed to the sink.

An entry is what a configuration's `entry` names: the program's call the
window drives, the program's counters that open the window and show
that nothing was built or captured inside it, its stage spans, and which
comparison judges what the sink received. The harness loads
`entries/<entry>.py` and builds its `Entry(config, decode, device)`.
"""

from __future__ import annotations

import time

from adsbench.yardstick import check, reference

# Counters that must not rise between the window's open and close.
BUILD_COUNTERS = ("eager", "captures")


class Entry:
    def __init__(self, config: dict, decode: dict, device: str):
        from airjax_torch import runner
        from airjax_torch.pipeline import graph_counts

        self.runner, self.graph_counts = runner, graph_counts
        self.decode, self.device = decode, device
        self.block = int(config["receiver"]["block_samples"])
        self.depth = int(decode["pipeline_depth"])
        self.overlap = bool(decode["overlap"])
        self.extended = bool(decode["extended"])
        self.stats = runner.StreamStats()
        self.captures0 = graph_counts["captures"]

    @property
    def warm_blocks(self) -> int:
        """Blocks driven before the window: the shape's first, eager block,
        then one a slot of the ring, each captured at its first use."""
        return self.depth + 2

    @property
    def block_shape(self) -> tuple[int, int]:
        """(samples a dispatched block, offsets it scans)."""
        if self.overlap:
            return self.block + reference.HALO, self.block
        return self.block, self.block - reference.HALO - 1

    def ready(self) -> None:
        """Wait until the warm-up blocks' graphs are captured (called from
        the source, on the runner's prefetch thread)."""
        deadline = time.perf_counter() + 1200.0
        while self.graph_counts["captures"] - self.captures0 < self.depth + 1:
            if time.perf_counter() > deadline:
                raise RuntimeError("the warm-up blocks' graphs were not captured in 1200 s")
            time.sleep(0.001)

    def snapshot(self) -> dict:
        stages = self.stats.stages
        totals = dict(stages.totals)
        return {
            "stages": {k: (totals.get(k, 0.0), n) for k, n in dict(stages.counts).items()},
            "blocks": self.stats.blocks,
            "detections": self.stats.detections,
            "counters": {k: self.graph_counts[k] for k in BUILD_COUNTERS},
        }

    def run(self, drive, sink) -> None:
        self.runner.run_stream(drive, sink, overlap=self.overlap, stats=self.stats, extended=self.extended,
                               pipeline_depth=self.depth, recover2=bool(self.decode["recover2"]),
                               device=self.device)

    def check(self, recorder, loop: dict, n_loop: int, n_stream: int, program_table: dict,
              aircraft: set) -> tuple[dict, dict]:
        """The comparison for this entry's sink: per packet (DF17 mode) or
        per block (extended mode)."""
        if self.extended:
            return check.check_blocks(recorder, loop, n_loop, n_stream, self.block, program_table, aircraft,
                                      overlap=self.overlap)
        return check.check_packets(recorder, loop, n_loop, n_stream, self.block, self.stats.recovered,
                                   program_table)

    def reference(self, iq) -> dict:
        """The plain reference's frames over one loop of the capture."""
        return reference.decode_extended(iq) if self.extended else reference.decode_df17(iq)

    def log(self) -> str:
        s = self.stats
        return (f"blocks {s.blocks}, good {s.good}, recovered {s.recovered}, overflow blocks {s.overflow_blocks}, "
                f"graphs {s.graphs}")
