"""Streaming runner: block source -> torch decode -> per-packet sink
(airjax/runner.py:38-69, :105-407, for per-packet sinks).

Two stream modes, as in airjax:
  * parity  — each chunk scanned on its own over offsets [0, len-240),
              like the reference; frames straddling chunk edges are lost.
  * overlap — a carry from the previous chunk is prepended, so every
              global offset is scanned exactly once and no frame is lost
              at a chunk edge.

The sink receives what airjax's receives, in stream order: an
`AdsbPacket.from_bytes(frame, now)` per validated DF17 frame, `now` taken
per block at dispatch. With extended=True every Mode S downlink format is
decoded (airjax/runner.py:182-212, :251-279): the block's candidate dict
goes through airjax_torch.extended.assemble_extended, which seeds the
ICAO cache from the whole block (the padded head of the first block
included) before the packets at global offsets below 0 are skipped. The
batched, recover2, plot and preamble-dump branches of airjax's runner are
not in this port yet.

Blocks are decoded one at a time: each block is uploaded, decoded, and
its results copied back and applied before the next is dispatched. Only
the source read overlaps the decode, on the Prefetcher's thread.
"""

from __future__ import annotations

import time
from typing import Callable, Iterator

import numpy as np
import torch

from airjax_torch.config import DEFAULT_CONFIG, PipelineConfig
from airjax_torch.io.source import Prefetcher
from airjax_torch.dsp.demod import WINDOW
from airjax_torch.observability import StageTimer
from airjax_torch.extended import assemble_extended
from airjax_torch.pipeline import decode_iq_block, decode_iq_block_extended, to_host
from airjax_torch.protocol.packet import AdsbPacket
from airjax_torch.track.icao_cache import IcaoCache

# Overlap-mode blocks at least this long use the shape-tuned scan
# (airjax/runner.py:31-35): a 1024-aligned slice with n_off = slice - 240.
# Kept so that the stream's blocks, and so its detection counts, match
# airjax's exactly; the emitted frames do not depend on it.
TUNED_STREAM_MIN = 1 << 16


class StreamStats:
    def __init__(self):
        self.blocks = 0
        self.samples = 0
        self.detections = 0
        self.good = 0
        self.recovered = 0
        self.overflow_blocks = 0
        self.started = time.time()
        # Host wall-clock per stage: dispatch (block prep + decode launch),
        # fetch (result copy + overflow regrow), apply (packets + sink).
        self.stages = StageTimer()

    def as_dict(self) -> dict:
        dt = max(time.time() - self.started, 1e-9)
        return {
            "blocks": self.blocks,
            "samples": self.samples,
            "detections": self.detections,
            "good": self.good,
            "recovered": self.recovered,
            "overflow_blocks": self.overflow_blocks,
            "msamples_per_s": round(self.samples / dt / 1e6, 3),
            "stages": self.stages.as_dict(),
        }


def run_stream(
    source: Iterator[np.ndarray],
    on_packet: Callable[[AdsbPacket], None],
    cfg: PipelineConfig = DEFAULT_CONFIG,
    overlap: bool = True,
    extended: bool = False,
    *,
    device: torch.device | str,
) -> StreamStats:
    """Consume a block source until exhausted; call on_packet per packet
    (with extended=True, also AllCallReply, SurveillanceReply, AcasReply
    and CommDReply objects)."""
    stats = StreamStats()
    decode = decode_iq_block_extended if extended else decode_iq_block
    icao_cache = IcaoCache()
    halo = WINDOW - 1
    # The initial carry is the non-detecting (1,0)-magnitude pattern: a
    # zero carry passes the equality-tolerant gate at every offset.
    carry = None
    if overlap:
        carry = np.zeros((halo, 2), dtype=np.int16)
        carry[::2, 0] = 1
    global_base = -halo  # global sample index of carry[0]
    pending = np.zeros((0, 2), dtype=np.int16)

    def _decode(ext: np.ndarray, n_off: int, base: int, n_samples: int) -> None:
        with stats.stages.stage("dispatch"):
            block_dev = torch.as_tensor(ext, device=device)
            out_dev = decode(block_dev, n_off, cfg.max_candidates)
            now = time.time()
        with stats.stages.stage("fetch"):
            out = to_host(out_dev)
            # Regrow on overflow: a dropped detection would lose a frame.
            overflowed = bool(out["overflow"])
            capacity = cfg.max_candidates
            while bool(out["overflow"]) and capacity < n_off:
                capacity = min(capacity * 4, n_off)
                out = to_host(decode(block_dev, n_off, capacity))
        t_apply = time.perf_counter()
        emitted = 0
        if extended:
            for local, packet in assemble_extended(out, now, icao_cache):
                if overlap and base + local < 0:
                    continue  # the padded head of the first block
                on_packet(packet)
                emitted += 1
        else:
            good = out["good"]
            if overlap:
                # int64 before adding the base: it passes 2^31 after ~18 min
                # of stream (airjax/runner.py:283-289). Offsets below 0 are
                # the padded head of the first block.
                good = good & (out["offsets"].astype(np.int64) + base >= 0)
            for k in np.nonzero(good)[0]:
                on_packet(AdsbPacket.from_bytes(out["frames"][k].tobytes(), now))
                emitted += 1
        stats.stages.add("apply", time.perf_counter() - t_apply)
        # The tail flush is an extra decode, not a source block (n_samples=0).
        stats.blocks += 1 if n_samples else 0
        stats.samples += n_samples
        stats.detections += int(out["n_detections"])
        stats.good += emitted
        stats.recovered += int(np.sum(out["recovered"]))
        # Blocks that needed a regrow (the regrown result's flag is clear).
        stats.overflow_blocks += overflowed

    for block in Prefetcher(source, depth=4):
        block = np.asarray(block, dtype=np.int16)
        if overlap and len(pending):
            # Short reads accumulate rather than being dropped.
            block = np.concatenate([pending, block], axis=0)
            pending = pending[:0]
        if block.shape[0] < WINDOW:
            if overlap:
                pending = block
            # parity: the reference cannot scan a block < 240 samples.
            continue
        if overlap:
            full = np.concatenate([carry, block], axis=0)
            if full.shape[0] >= TUNED_STREAM_MIN:
                slice_len = (full.shape[0] // 1024) * 1024
                n_off = slice_len - 240
                ext = full[:slice_len]
            else:
                n_off = full.shape[0] - halo
                ext = full
            carry = full[n_off:].copy()
        else:
            n_off = block.shape[0] - WINDOW
            ext = block
        _decode(ext, n_off, global_base, block.shape[0])
        if overlap:
            global_base += n_off
    if overlap and len(pending):
        # A final short read still ends the stream: frames ending inside
        # it are scannable once appended to the carry.
        carry = np.concatenate([carry, pending], axis=0)
    if overlap and carry.shape[0] > halo:
        # Tail flush: the carry's offsets whose windows end at the stream end.
        _decode(carry, carry.shape[0] - halo, global_base, 0)
    return stats
